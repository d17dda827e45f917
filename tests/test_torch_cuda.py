"""The Hopper fused-scan kernel against its plain PyTorch version, on a card.

Every test here needs a CUDA device and skips without one; none imports
JAX.  Run them on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 0: counts are f32 integers, exact below 2^24 in any order of
summation, so kernel and plain version agree bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.data import StreamSpec, random_stream
from repro_torch.kernels import fused_scan
from repro_torch.kernels import ops
from repro_torch.kernels import window as wkern
from repro_torch.vector import StreamingVectorEngine, VectorEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused-scan kernel is CUDA C++ "
                    "and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_tables(rng, S, C, A, k, NQ):
    """Random tables whose rows hold at most one 1, so run counts cannot
    grow past 2^24 however wide the window; branching tables are covered by
    the real queries of the streaming test and of chip_smoke.py."""
    specs = tuple((int(rng.integers(0, A)), int(rng.integers(0, 6)),
                   float(np.float32(rng.normal()))) for _ in range(k))
    class_of = rng.integers(0, C, 1 << k).astype(np.int32)
    M = np.zeros((C, S, S), np.float32)
    for s in range(1, S):
        for c in range(C):
            if rng.random() < 0.8:
                M[c, s, rng.integers(1, S)] = 1.0
    finals = (rng.random((NQ, S)) < 0.4).astype(np.float32)
    finals[:, 0] = 0.0
    init = np.zeros(S, np.float32)
    init[1] = 1.0
    return specs, class_of, M, finals, init


def equal(a, b):
    if isinstance(a, dict):
        return all(torch.equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


# (S, NQ, W-or-size, timed): the 8/16/32-state builds, a ring too large for
# shared memory (W·S·4 > 227 KB), time windows, several queries
CASES = [(5, 1, 7, False), (9, 2, 31, False), (26, 3, 100, False),
         (15, 1, 4000, False), (7, 2, 9.0, True), (13, 1, 40.0, True)]


@pytest.mark.parametrize("S,NQ,win,timed", CASES)
@pytest.mark.parametrize("latest,consume", [(False, False), (True, True)])
def test_kernel_matches_plain_version(dev, S, NQ, win, timed, latest,
                                      consume):
    rng = np.random.default_rng(S * 31 + NQ)
    B, T, A, k, C = 37, 64, 3, 5, 6
    specs, class_of, M, finals, init = random_tables(rng, S, C, A, k, NQ)
    attrs = rng.normal(size=(T, B, A)).astype(np.float32)
    attrs[rng.random((T, B, A)) < 0.05] = np.nan
    ts = np.cumsum(rng.integers(0, 3, (T, B)), axis=0).astype(np.float32)
    window = (wkern.DeviceWindow.time(win, max_window_events=48) if timed
              else wkern.DeviceWindow.events(win))
    c0 = wkern.init_state(window, B, S, dev)
    ring = c0["C"] if timed else c0
    ring.copy_(torch.from_numpy(
        (rng.random(ring.shape) < 0.05).astype(np.float32)))
    start = rng.integers(0, 5000, B)
    start[:5] = 0
    consume_sq = None
    if consume:
        consume_sq = torch.zeros((NQ, S), device=dev)
        consume_sq[0] = 1.0
    latest_q = None
    if latest:
        latest_q = torch.zeros(NQ, device=dev)
        latest_q[-1] = 1.0
    args = (torch.from_numpy(attrs).to(dev), specs,
            torch.from_numpy(class_of).to(dev),
            ops.class_indicator(class_of, C).to(dev),
            torch.from_numpy(M).to(dev), torch.from_numpy(finals).to(dev))
    kw = dict(init_mask=torch.from_numpy(init).to(dev), window=window,
              event_ts=torch.from_numpy(ts).to(dev) if timed else None,
              start_pos=torch.from_numpy(start).to(dev),
              valid_counts=torch.from_numpy(
                  rng.integers(0, T + 1, B)).to(dev),
              return_trace=True, latest_q=latest_q, consume_sq=consume_sq)
    launches = fused_scan.KERNEL.launches
    got = ops.cer_pipeline(*args, c0, impl="fused", **kw)
    torch.cuda.synchronize()
    assert fused_scan.KERNEL.launches == launches + 1
    want = ops.cer_pipeline(*args, c0, impl="ref", **kw)
    for g, w in zip(got, want):
        assert equal(g, w)
    assert float(got[0].max()) < 2 ** 24


def test_streaming_engine_on_card(dev):
    """Chunks through the kernel equal the plain route and the host-free
    CPU run; the library is loaded once."""
    query = "SELECT * FROM S WHERE A1 ; A2+ ; A3 WITHIN 50 events"
    B, T = 8, 32
    streams = [random_stream(StreamSpec(["A1", "A2", "A3"], seed=b), 4 * T)
               for b in range(B)]
    runs, states = {}, {}
    for name, device, impl in (("kernel", None, None),
                               ("plain", None, "ref"),
                               ("cpu", "cpu", None)):
        se = StreamingVectorEngine(VectorEngine(query, device=device,
                                                impl=impl), T, B)
        runs[name] = [se.feed([s[i * T:(i + 1) * T] for s in streams])
                      for i in range(4)]
        states[name] = se.state.cpu()
        if name == "kernel":
            assert se.compile_count == 1
    for name in ("plain", "cpu"):
        for (ck, hk), (cp, hp) in zip(runs["kernel"], runs[name]):
            np.testing.assert_array_equal(ck, cp)
            assert hk == hp
        assert torch.equal(states["kernel"], states[name])


def test_router_raises_on_what_the_kernel_refuses(dev):
    B, T, S = 2, 4, 40
    rng = np.random.default_rng(0)
    specs, class_of, M, finals, init = random_tables(rng, S, 3, 2, 2, 1)
    with pytest.raises(ValueError, match="det states"):
        ops.cer_pipeline(
            torch.zeros((T, B, 2), device=dev), specs,
            torch.from_numpy(class_of).to(dev), None,
            torch.from_numpy(M).to(dev), torch.from_numpy(finals).to(dev),
            torch.zeros((B, 8, S), device=dev),
            init_mask=torch.from_numpy(init).to(dev), epsilon=3)
