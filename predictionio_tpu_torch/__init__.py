"""PyTorch/CUDA port of pio-tpu for one NVIDIA H100.

`predictionio_tpu/` (JAX, written for a TPU) is the reference; this
package mirrors its module names so each counterpart is easy to find.
It imports `torch` and numpy, never `jax`, and nothing from
`predictionio_tpu`: what it needs from there it keeps as its own copy.

Entry points run on the card (`device="cuda"`, the default) and raise
`RuntimeError` when CUDA is absent; they run on the CPU only when the
caller passes `device="cpu"`, as the tests do.

The recommendation and similar-product templates run from the event store
through `python -m predictionio_tpu_torch train` (explicit and implicit
ALS on the hand-written Hopper solve kernels, `csrc/`) to `deploy`, whose
server micro-batches queries as the reference's does.
"""

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]


def __getattr__(name):
    # `resolve_device` on first use, so importing the package (the
    # command line's `lint`, `version`) does not import torch
    if name == "resolve_device":
        from predictionio_tpu_torch.device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
