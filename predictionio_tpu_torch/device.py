"""Device selection: the card unless the caller asks for the CPU.

There is no silent fallback. `None` and `"cuda"` require CUDA and raise
`RuntimeError` without it, so a run that was meant for the card can never
quietly measure the CPU.

Matmuls run in full float32 on the card: `resolve_device` turns TF32 off
for both cuBLAS matmuls and cuDNN whenever it hands out a CUDA device,
because the ALS normal equations and the CG kernel are compared with the
reference at f32 tolerances that TF32's ~3 decimal digits would break.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def use_full_f32() -> None:
    """Disable TF32 for matmuls and convolutions (explicit, not default-
    reliant: cuDNN's default is TF32 on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None`/`"cuda"`/`"cuda:N"` -> that CUDA device (raises without
    CUDA); `"cpu"` -> the CPU, only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         "'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: predictionio_tpu_torch runs on the "
            "card by default; pass device='cpu' to run on the CPU")
    use_full_f32()
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on the device's current stream (a no-op
    on the CPU). Never a device-wide synchronize: one while another
    thread captures a CUDA graph (`compile/aot.py`) would invalidate the
    capture and fail."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
