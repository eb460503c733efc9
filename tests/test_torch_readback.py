"""Port parity: the serve readback plane (`ops/readback.py`) vs the JAX
reference's, on the CPU.

The packed payload is held byte for byte: the port's `pack_device` on
torch tensors and the reference's on JAX arrays, from the same seeded
scores and ids, give the same `[B, K, slot]` uint8 bytes under `on` (f16
scores, 6 bytes a slot) and `exact` (f32, 8 bytes), -inf slots, f16
overflow and subnormals included. `unpack_host` round-trips both (exactly
in `exact`, to the f16 value in `on`), and the `PIO_SERVE_PACK`
spellings select the same modes in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import readback as JRB
from predictionio_tpu_torch.ops import readback as TRB

B, K = 5, 12


def scores_and_ids(seed=0):
    rng = np.random.default_rng(seed)
    scores = (rng.standard_normal((B, K)) * 40).astype(np.float32)
    scores[0, -3:] = -np.inf                  # masked slots
    scores[1, 0] = 70000.0                    # past f16's largest finite
    scores[1, 1] = -65519.0                   # rounds to f16's -65504
    scores[2, 2] = 3e-6                       # an f16 subnormal
    scores[2, 3] = 1.0 + 2.0 ** -12           # a tie-to-even in f16
    ids = rng.integers(0, 1 << 30, (B, K)).astype(np.int32)
    ids[3, 0] = -1
    return scores, ids


@pytest.mark.parametrize("mode", [JRB.PACK_F16, JRB.PACK_EXACT])
def test_pack_device_is_byte_equal_to_the_reference(mode):
    scores, ids = scores_and_ids()
    want = np.asarray(JRB.pack_device(jnp.asarray(scores),
                                      jnp.asarray(ids), mode))
    got = TRB.pack_device(torch.from_numpy(scores), torch.from_numpy(ids),
                          mode).numpy()
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (B, K, TRB.SLOT_BYTES[mode])
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("mode", [TRB.PACK_F16, TRB.PACK_EXACT])
def test_unpack_host_round_trips(mode):
    scores, ids = scores_and_ids(1)
    buf = TRB.pack_device(torch.from_numpy(scores), torch.from_numpy(ids),
                          mode).numpy()
    sc, ix = TRB.unpack_host(buf, mode)
    np.testing.assert_array_equal(ix, ids)
    with np.errstate(over="ignore"):     # 70000 -> inf, on purpose
        want = scores if mode == TRB.PACK_EXACT else \
            scores.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(sc, want)
    assert sc.dtype == np.float32 and ix.dtype == np.int32
    if mode == TRB.PACK_F16:
        assert np.isneginf(sc[0, -3:]).all() and sc[1, 0] == np.inf
        assert sc[1, 1] == -65504.0
    jsc, jix = JRB.unpack_host(buf, mode)
    np.testing.assert_array_equal(jsc, sc)
    np.testing.assert_array_equal(jix, ix)


@pytest.mark.parametrize("raw", [None, "on", "ON", " exact ", "off", "0",
                                 "false", "no", "f16", "yes", ""])
def test_pack_flag_reads_the_reference_spellings(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("PIO_SERVE_PACK", raising=False)
    else:
        monkeypatch.setenv("PIO_SERVE_PACK", raw)
    assert TRB.pack_flag() == JRB.pack_flag()
    assert TRB.SLOT_BYTES == JRB.SLOT_BYTES
    assert (TRB.PACK_OFF, TRB.PACK_F16, TRB.PACK_EXACT) == \
        (JRB.PACK_OFF, JRB.PACK_F16, JRB.PACK_EXACT)


def test_begin_fetch_counts_windows_bytes_and_thread_totals():
    scores, ids = scores_and_ids(2)
    before = TRB.stats_snapshot()
    w0 = TRB.thread_wait_s()
    packed = TRB.pack_device(torch.from_numpy(scores),
                             torch.from_numpy(ids), TRB.PACK_F16)
    sc, ix = TRB.begin_fetch_packed(packed, TRB.PACK_F16)()
    np.testing.assert_array_equal(ix, ids)
    s2, i2 = TRB.begin_fetch(torch.from_numpy(scores),
                             torch.from_numpy(ids))()
    np.testing.assert_array_equal(s2, scores)
    after = TRB.stats_snapshot()
    assert after["windows"] - before["windows"] == 2
    assert after["bytes"] - before["bytes"] == B * K * (6 + 8)
    assert TRB.thread_wait_s() >= w0
    assert 0.0 <= TRB.overlap_frac(after, before) <= 1.0
    assert TRB.overlap_frac(before, before) == 1.0


def test_to_device_keeps_a_cpu_array_on_the_cpu():
    a = np.arange(6, dtype=np.int64).reshape(2, 3)
    t = TRB.to_device(a, torch.device("cpu"))
    assert t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), a)
