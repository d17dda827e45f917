"""The port's counting pipeline against the reference package.

On the CPU the port's ``cer_pipeline`` runs its plain PyTorch version; it
must equal the JAX package's ``impl="ref"`` oracle and its ``impl="fused"``
Pallas kernel (interpret mode) exactly — tolerance 0: counts are f32
integers, exact below 2^24 in any order of summation.  The Hopper kernel is
held against the plain version in ``test_torch_cuda.py``, which runs on a
card and needs no JAX.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as j_ops
from repro.kernels import window as j_window
from repro.kernels.cea_scan import (_ring_masks, _ring_masks_lanes,
                                    _ring_masks_time)
from repro_torch.kernels import fused_scan
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import window as t_window


def random_case(seed, S, C, A, k, B, T, NQ=1, gaps=(1, 4)):
    """Random specs, tables, attributes and timestamps, made with numpy."""
    rng = np.random.default_rng(seed)
    specs = tuple((int(rng.integers(0, A)), int(rng.integers(0, 6)),
                   float(np.float32(rng.normal()))) for _ in range(k))
    class_of = rng.integers(0, C, 1 << k).astype(np.int32)
    M = np.zeros((C, S, S), np.float32)
    for s in range(1, S):
        for c in range(C):
            for _ in range(2):
                if rng.random() < 0.6:
                    M[c, s, rng.integers(1, S)] += 1
    finals = (rng.random((NQ, S)) < 0.4).astype(np.float32)
    finals[:, 0] = 0.0
    init = np.zeros(S, np.float32)
    init[1] = 1.0
    attrs = rng.normal(size=(T, B, A)).astype(np.float32)
    attrs[rng.random((T, B, A)) < 0.05] = np.nan          # NULL attributes
    ts = np.cumsum(rng.integers(*gaps, size=(T, B)), axis=0).astype(
        np.float32)
    return dict(specs=specs, class_of=class_of, M=M, finals=finals,
                init=init, attrs=attrs, ts=ts, rng=rng)


def run_both(case, c0_np, window_j, window_t, *, start_pos=0,
             valid_counts=None, latest_q=None, consume_sq=None,
             return_trace=False, j_impls=("ref", "fused")):
    """Run every JAX impl and the port's CPU route on the same inputs."""
    C = case["M"].shape[0]
    timed = window_j.is_time
    j_args = (jnp.asarray(case["class_of"]),
              j_ops.class_indicator(case["class_of"], C),
              jnp.asarray(case["M"]), jnp.asarray(case["finals"]))
    t_args = (torch.from_numpy(case["class_of"]),
              t_ops.class_indicator(case["class_of"], C),
              torch.from_numpy(case["M"]), torch.from_numpy(case["finals"]))

    def j_state():
        if timed:
            return {k: jnp.asarray(v) for k, v in c0_np.items()}
        return jnp.asarray(c0_np)

    def t_state():
        if timed:
            return {k: torch.from_numpy(v.copy()) for k, v in c0_np.items()}
        return torch.from_numpy(c0_np.copy())

    def lane(x, mod):
        if x is None or np.ndim(x) == 0:
            return x
        return mod(np.asarray(x, np.int32))

    j_kw = dict(init_mask=jnp.asarray(case["init"]), window=window_j,
                event_ts=jnp.asarray(case["ts"]) if timed else None,
                start_pos=lane(start_pos, jnp.asarray),
                valid_counts=lane(valid_counts, jnp.asarray),
                return_trace=return_trace,
                latest_q=None if latest_q is None else jnp.asarray(latest_q),
                consume_sq=(None if consume_sq is None
                            else jnp.asarray(consume_sq)))
    t_kw = dict(init_mask=torch.from_numpy(case["init"]), window=window_t,
                event_ts=torch.from_numpy(case["ts"]) if timed else None,
                start_pos=lane(start_pos, torch.from_numpy),
                valid_counts=lane(valid_counts, torch.from_numpy),
                return_trace=return_trace,
                latest_q=(None if latest_q is None
                          else torch.from_numpy(latest_q)),
                consume_sq=(None if consume_sq is None
                            else torch.from_numpy(consume_sq)))
    outs = {impl: j_ops.cer_pipeline(jnp.asarray(case["attrs"]),
                                     case["specs"], *j_args, j_state(),
                                     impl=impl, **j_kw)
            for impl in j_impls}
    outs["port"] = t_ops.cer_pipeline(torch.from_numpy(case["attrs"]),
                                      case["specs"], *t_args, t_state(),
                                      impl="fused", **t_kw)
    return outs


def to_np(x):
    if isinstance(x, dict):
        return {k: to_np(v) for k, v in x.items()}
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(outs):
    """Every output of every run equals the port's, exactly."""
    port = [to_np(x) for x in outs["port"]]
    for impl, res in outs.items():
        assert len(res) == len(port), impl
        for got, want in zip((to_np(x) for x in res), port):
            if isinstance(want, dict):
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k],
                                                  err_msg=f"{impl} {k}")
            else:
                assert got.dtype == want.dtype, (impl, got.dtype, want.dtype)
                np.testing.assert_array_equal(got, want, err_msg=impl)


def count_windows(eps):
    return j_window.DeviceWindow.events(eps), t_window.DeviceWindow.events(eps)


def time_windows(size, mwe):
    return (j_window.DeviceWindow.time(size, max_window_events=mwe),
            t_window.DeviceWindow.time(size, max_window_events=mwe))


def time_state(B, W, S, rng=None):
    C = np.zeros((B, W, S), np.float32)
    ts = np.full((B, W), -np.inf, np.float32)
    return {"C": C, "ts": ts, "ovf": np.zeros((B,), bool)}


# ---------------------------------------------------------------------------
# count windows, scalar and per-lane offsets, traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,C,k,A,B,T,eps,start", [
    (4, 3, 2, 1, 1, 9, 3, 0), (7, 5, 4, 3, 3, 33, 7, 5),
    (13, 8, 6, 4, 4, 17, 12, 61), (26, 12, 7, 3, 2, 24, 40, 1000)])
def test_count_window_matches_reference(S, C, k, A, B, T, eps, start):
    case = random_case(S * 100 + B * 10 + eps, S, C, A, k, B, T)
    jw, tw = count_windows(eps)
    c0 = np.zeros((B, jw.ring, S), np.float32)
    assert_same(run_both(case, c0, jw, tw, start_pos=start))


@pytest.mark.parametrize("eps,start", [(3, 0), (9, 2), (15, 1)])
def test_early_negative_expire_indices_wrap(eps, start):
    """(j-ε-1) is negative for the first ε+1 positions; Python's sign rule
    wraps it onto a live-but-empty slot, and a non-empty carried ring shows
    whether that slot is the right one."""
    case = random_case(eps + start, 5, 4, 2, 3, 2, 20)
    jw, tw = count_windows(eps)
    c0 = case["rng"].integers(0, 3, (2, jw.ring, 5)).astype(np.float32)
    c0[:, :, 0] = 0.0
    assert_same(run_both(case, c0, jw, tw, start_pos=start))


@pytest.mark.parametrize("timed", [False, True])
def test_per_lane_offsets_and_valid_counts(timed):
    B, T, S = 4, 24, 6
    case = random_case(7 + timed, S, 4, 3, 4, B, T)
    start = np.array([0, 5, 17, 3], np.int32)
    valid = np.array([24, 0, 11, 19], np.int32)
    if timed:
        jw, tw = time_windows(6.0, 16)
        c0 = time_state(B, jw.ring, S)
    else:
        jw, tw = count_windows(6)
        c0 = np.zeros((B, jw.ring, S), np.float32)
    assert_same(run_both(case, c0, jw, tw, start_pos=start,
                         valid_counts=valid))


@pytest.mark.parametrize("timed", [False, True])
def test_return_trace(timed):
    B, T, S = 3, 21, 9
    case = random_case(11, S, 5, 3, 4, B, T)
    if timed:
        jw, tw = time_windows(10.0, 24)
        c0 = time_state(B, jw.ring, S)
    else:
        jw, tw = count_windows(7)
        c0 = np.zeros((B, jw.ring, S), np.float32)
    outs = run_both(case, c0, jw, tw, return_trace=True,
                    valid_counts=np.array([21, 13, 0], np.int32))
    assert outs["port"][2].dtype == torch.int32
    assert_same(outs)


# ---------------------------------------------------------------------------
# time windows: eviction by timestamp, the ovf latch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,mwe,gaps", [(8.0, 16, (1, 3)),
                                           (20.0, 8, (0, 2)),
                                           (5.5, 40, (1, 5))])
def test_time_window_matches_reference(size, mwe, gaps):
    B, T, S = 3, 40, 7
    case = random_case(int(size * 10) + mwe, S, 5, 3, 4, B, T, gaps=gaps)
    jw, tw = time_windows(size, mwe)
    outs = run_both(case, time_state(B, jw.ring, S), jw, tw, start_pos=3)
    assert_same(outs)
    # the (20, 8) case holds more live starts than slots: ovf must latch
    if mwe == 8:
        assert outs["port"][1]["ovf"].any()


# ---------------------------------------------------------------------------
# LAST and CONSUME BY ANY
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("timed", [False, True])
@pytest.mark.parametrize("latest,consume", [(True, False), (False, True),
                                            (True, True)])
def test_last_and_consume(timed, latest, consume):
    B, T, S, NQ = 3, 30, 8, 2
    case = random_case(3 * latest + consume + 5 * timed, S, 5, 3, 4, B, T,
                       NQ=NQ)
    latest_q = np.array([1.0, 0.0], np.float32) if latest else None
    consume_sq = None
    if consume:
        consume_sq = np.zeros((NQ, S), np.float32)
        consume_sq[0, :] = 1.0
    if timed:
        jw, tw = time_windows(9.0, 24)
        c0 = time_state(B, jw.ring, S)
    else:
        jw, tw = count_windows(10)
        c0 = np.zeros((B, jw.ring, S), np.float32)
    assert_same(run_both(case, c0, jw, tw, start_pos=4,
                         valid_counts=np.array([30, 22, 9], np.int32),
                         latest_q=latest_q, consume_sq=consume_sq))


# ---------------------------------------------------------------------------
# helpers, contract errors, kernel limits
# ---------------------------------------------------------------------------

def test_ring_mask_helpers_match_reference():
    W, eps = 16, 9
    for j in (0, 3, 9, 10, 31):
        for a, b in zip(_ring_masks(jnp.int32(j), W, eps),
                        t_ref.ring_masks(j, W, eps)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    j = np.array([0, 4, 9, 10, 40], np.int32)
    for a, b in zip(_ring_masks_lanes(jnp.asarray(j), W, eps),
                    t_ref.ring_masks_lanes(torch.from_numpy(j), W, eps)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    rng = np.random.default_rng(0)
    tsr = rng.integers(0, 20, (5, W)).astype(np.float32)
    tsr[:, :3] = -np.inf
    ts_t = np.array([3, 9, 15, 19.5, 30], np.float32)
    for a, b in zip(_ring_masks_time(jnp.asarray(j), jnp.asarray(ts_t),
                                     jnp.asarray(tsr), W, jnp.float32(6.5)),
                    t_ref.ring_masks_time(torch.from_numpy(j),
                                          torch.from_numpy(ts_t),
                                          torch.from_numpy(tsr), W, 6.5)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _small_call(**kw):
    case = random_case(0, 4, 3, 2, 2, 2, 5)
    args = (torch.from_numpy(case["attrs"]), case["specs"],
            torch.from_numpy(case["class_of"]),
            t_ops.class_indicator(case["class_of"], 3),
            torch.from_numpy(case["M"]), torch.from_numpy(case["finals"]),
            torch.zeros((2, 8, 4)))
    base = dict(init_mask=torch.from_numpy(case["init"]), epsilon=3)
    base.update(kw)
    return t_ops.cer_pipeline(*args, **base)


def test_contract_errors():
    with pytest.raises(ValueError, match="impl must be one of"):
        _small_call(impl="xla")
    with pytest.raises(ValueError, match="needs epsilon= or window="):
        _small_call(epsilon=None)
    jw, tw = time_windows(4.0, 8)
    with pytest.raises(ValueError, match="event_ts"):
        _small_call(epsilon=None, window=tw)
    with pytest.raises(ValueError, match=r"event_ts must be \(T, B\)"):
        _small_call(epsilon=None, window=tw, event_ts=torch.zeros((2, 5)))
    with pytest.raises(ValueError, match="event_ts"):
        _small_call(impl="unfused", epsilon=None, window=tw)
    # the unfused path is ported: on the CPU it equals the fused route
    unfused, fused = _small_call(impl="unfused"), _small_call(impl="fused")
    assert all(torch.equal(a, b) for a, b in zip(unfused, fused))


@pytest.mark.parametrize("limit,kw", [
    ("predicates", dict(k=17)), ("queries", dict(NQ=-1)),
    ("queries", dict(NQ=0)), ("det states", dict(S=513)),
    ("epsilon", dict(W=8, epsilon=8))])
def test_kernel_refuses_shapes_before_launch(limit, kw):
    args = dict(T=4, B=2, S=7, NQ=1, k=3, W=16, epsilon=5, timed=False)
    args.update(kw)
    with pytest.raises(ValueError, match=limit):
        fused_scan.check_launchable(**args)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors only; the CPU route is the
    router's, never the wrapper's."""
    case = random_case(1, 4, 3, 2, 2, 2, 5)
    before = fused_scan.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_scan.KERNEL(
            torch.from_numpy(case["attrs"]), case["specs"],
            torch.from_numpy(case["class_of"]), torch.from_numpy(case["M"]),
            torch.from_numpy(case["finals"]), torch.from_numpy(case["init"]),
            torch.zeros((2, 8, 4)), torch.zeros(2, dtype=torch.int32),
            torch.full((2,), 5, dtype=torch.int32), epsilon=3)
    assert fused_scan.KERNEL.launches == before
