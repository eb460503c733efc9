"""Port hygiene: predictionio_tpu_torch and chip_smoke.py stand alone
(no JAX, nothing of the JAX package), and the entry points run on the
card unless the caller asks for the CPU by name."""

import importlib
import pathlib
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import predictionio_tpu_torch
from predictionio_tpu_torch import device as D
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.models.common import RatingsData
from predictionio_tpu_torch.ops import als as TA
from predictionio_tpu_torch.ops.ratings import RatingsCOO
from predictionio_tpu_torch.weights import from_jax_model

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "predictionio_tpu_torch"


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        predictionio_tpu_torch.__path__, "predictionio_tpu_torch."))


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = port_modules() + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or\n"
        "             n.startswith(('jax.', 'jaxlib')) or\n"
        "             n == 'predictionio_tpu' or\n"
        "             n.startswith('predictionio_tpu.'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"loaded: {out.stdout.strip()}"
    assert "predictionio_tpu_torch.ops.solve" in mods


def test_port_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|predictionio_tpu)"
                     r"(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [str(f.relative_to(REPO)) for f in files
            if pat.search(f.read_text())]
    assert hits == []


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def tiny_coo():
    rng = np.random.default_rng(0)
    ui = rng.integers(0, 6, 30).astype(np.int32)
    ii = rng.integers(0, 5, 30).astype(np.int32)
    pair = np.unique(ui.astype(np.int64) * 5 + ii)
    return RatingsCOO((pair // 5).astype(np.int32),
                      (pair % 5).astype(np.int32),
                      np.ones(pair.size, np.float32), 6, 5)


def test_resolve_device_requires_cuda_unless_cpu_is_asked(no_cuda):
    for dev in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            D.resolve_device(dev)
    assert D.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        D.resolve_device("meta")


def test_entry_points_default_to_the_card(no_cuda):
    coo = tiny_coo()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TA.als_train(coo, TA.ALSConfig(rank=4, iterations=1))
    model = TA.als_train(coo, TA.ALSConfig(rank=4, iterations=1),
                         device="cpu")
    assert model.device.type == "cpu"

    pd = TR.RecommendationPreparator().prepare(TR.TrainingData(RatingsData(
        ["u1", "u2", "u2"], ["i1", "i1", "i2"], [4.0, 3.0, 5.0])))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TR.ALSAlgorithm(TR.ALSAlgorithmParams(rank=2)).train(pd)
    assert TR.ALSAlgorithm(TR.ALSAlgorithmParams(
        rank=2, device="cpu")).train(pd).als.device.type == "cpu"

    U, V = np.ones((2, 2), np.float32), np.ones((3, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_jax_model(U, V, ["a", "b"], ["x", "y", "z"], 2)
    assert from_jax_model(U, V, ["a", "b"], ["x", "y", "z"], 2,
                          device="cpu").als.device.type == "cpu"


def test_similarproduct_entry_points_default_to_the_card(no_cuda):
    from predictionio_tpu_torch.models import similarproduct as TS
    from predictionio_tpu_torch.weights import from_jax_similarproduct_model
    td = TS.TrainingData(
        users={}, items={"x": TS.Item(("c",)), "y": TS.Item(("c",))},
        view_events=[TS.ViewEvent("u1", "x"), TS.ViewEvent("u2", "y"),
                     TS.ViewEvent("u2", "x")])
    pd = TS.SimilarProductPreparator().prepare(td)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.ALSAlgorithm(TS.ALSAlgorithmParams(rank=2)).train(pd)
    model = TS.ALSAlgorithm(TS.ALSAlgorithmParams(
        rank=2, num_iterations=1, device="cpu")).train(pd)
    assert model.device.type == "cpu" and model.table().device.type == "cpu"
    T = np.eye(2, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_jax_similarproduct_model(T, ["x", "y"], td.items)
    assert from_jax_similarproduct_model(
        T, ["x", "y"], td.items, device="cpu").device.type == "cpu"


def test_resolving_the_card_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert D.resolve_device(None) == torch.device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_chip_smoke_refuses_to_run_without_a_card():
    code = ("import torch, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "import chip_smoke\n"
            "sys.exit(chip_smoke.main())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_every_port_module_imports_here():
    """The CPU tests import every module: nothing may build a kernel or
    touch the card at import time."""
    for name in port_modules():
        importlib.import_module(name)
