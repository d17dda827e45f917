"""The port's unfused pipeline against the reference package, on the CPU.

On CPU tensors ``ops.bitvector``, ``ops.cea_scan``, ``ops.cea_scan_multi``
and ``cer_pipeline(impl="unfused")`` run their plain PyTorch versions; they
must equal the JAX package's ``ops`` (its XLA path, and its Pallas kernels
in interpret mode on a few small shapes) exactly — tolerance 0: counts are
f32 integers, exact below 2^24 in any order of summation, and bits and
class ids are int32.  The Hopper kernels are held against the plain
versions in ``test_torch_cuda.py`` and ``chip_smoke.py``, on a card.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.data.streams import StreamSpec as JSpec
from repro.data.streams import random_stream as j_random
from repro.kernels import ops as j_ops
from repro.kernels.window import DeviceWindow as JWindow
from repro.vector import VectorEngine as JVector
from repro_torch.data import StreamSpec as TSpec
from repro_torch.data import random_stream as t_random
from repro_torch.kernels import bitvector as t_bitvector
from repro_torch.kernels import cea_scan as t_scan
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels.ref import (OP_EQ, OP_GE, OP_GT, OP_LE, OP_LT,
                                     OP_NE)
from repro_torch.kernels.window import DeviceWindow as TWindow
from repro_torch.vector import VectorEngine as TVector


def random_tables(rng, S, C):
    """The reference tests' tables: entries of 2 where both successors
    coincide."""
    dm = rng.integers(0, S, (S, C))
    du = rng.integers(0, S, (S, C))
    M = np.zeros((C, S, S), np.float32)
    for s in range(1, S):
        for c in range(C):
            if dm[s, c]:
                M[c, s, dm[s, c]] += 1
            if du[s, c]:
                M[c, s, du[s, c]] += 1
    finals = (rng.random(S) < 0.4).astype(np.float32)
    finals[0] = 0.0
    return M, finals


def equal(port, ref_):
    a = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref_)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# bitvector
# ---------------------------------------------------------------------------


def bitvector_case(B, A, k):
    rng = np.random.default_rng(B * 131 + A)
    attrs = rng.normal(size=(B, A)).astype(np.float32)
    attrs[rng.random((B, A)) < 0.05] = np.nan
    specs = [(int(rng.integers(0, A)), int(rng.integers(0, 6)),
              float(rng.normal())) for _ in range(k)]
    return attrs, specs


@pytest.mark.parametrize("B", [1, 7, 64, 300])
@pytest.mark.parametrize("A,k", [(1, 1), (3, 4), (8, 12)])
def test_bitvector_equals_reference(B, A, k):
    attrs, specs = bitvector_case(B, A, k)
    got = t_ops.bitvector(torch.from_numpy(attrs), specs)
    assert got.dtype == torch.int32
    equal(got, j_ops.bitvector(jnp.asarray(attrs), specs, use_pallas=False))


@pytest.mark.parametrize("B,A,k", [(7, 3, 4), (300, 8, 12)])
def test_bitvector_equals_pallas_interpret(B, A, k):
    attrs, specs = bitvector_case(B, A, k)
    equal(t_ops.bitvector(torch.from_numpy(attrs), specs),
          j_ops.bitvector(jnp.asarray(attrs), specs, use_pallas=True,
                          interpret=True))


def test_bitvector_ops_exact():
    attrs = np.asarray([[1.0, 2.0], [2.0, 2.0], [3.0, -1.0]], np.float32)
    specs = [(0, OP_EQ, 2.0), (0, OP_GT, 1.0), (1, OP_LE, 2.0),
             (1, OP_NE, -1.0), (0, OP_LT, 3.0), (0, OP_GE, 3.0)]
    got = t_ops.bitvector(torch.from_numpy(attrs), specs)
    # by hand, as in the reference package's test: 0b011100, 0b011111,
    # 0b100110
    equal(got, [28, 31, 38])
    equal(got, j_ops.bitvector(jnp.asarray(attrs), specs))


def test_bitvector_nan_fails_all_but_ne():
    """NULL attributes encode as NaN: every compare fails but NE."""
    attrs = torch.tensor([[np.nan]], dtype=torch.float32)
    specs = [(0, op, 0.0) for op in (OP_EQ, OP_LT, OP_LE, OP_GT, OP_GE)]
    assert int(t_ops.bitvector(attrs, specs)[0]) == 0
    assert int(t_ops.bitvector(attrs, specs + [(0, OP_NE, 0.0)])[0]) == 32
    j = j_ops.bitvector(jnp.asarray(attrs.numpy()),
                        specs + [(0, OP_NE, 0.0)])
    assert int(np.asarray(j)[0]) == 32


def test_bitvector_threshold_rounds_to_f32():
    """Python-float thresholds are rounded to f32 before the compare."""
    thr = 0.1                                   # not exact in f32
    attrs = np.asarray([[np.float32(thr)]], np.float32)
    specs = [(0, OP_EQ, thr), (0, OP_LE, thr), (0, OP_GT, thr)]
    got = t_ops.bitvector(torch.from_numpy(attrs), specs)
    equal(got, [3])
    equal(got, j_ops.bitvector(jnp.asarray(attrs), specs, use_pallas=False))


def test_bitvector_refusals():
    attrs = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="at most 31"):
        t_ops.bitvector(attrs, [(0, OP_EQ, 0.0)] * 32)
    with pytest.raises(ValueError, match="column 2 outside"):
        t_ops.bitvector(attrs, [(2, OP_EQ, 0.0)])
    with pytest.raises(ValueError, match="op code 6"):
        t_ops.bitvector(attrs, [(0, 6, 0.0)])
    # the kernel wrapper refuses CPU tensors before it builds anything
    with pytest.raises(ValueError, match="must be on CUDA"):
        t_bitvector.KERNEL(attrs, [(0, OP_EQ, 0.0)])


# ---------------------------------------------------------------------------
# cea_scan / cea_scan_multi
# ---------------------------------------------------------------------------


def scan_case(S, C, B, T, eps, seed):
    rng = np.random.default_rng(seed)
    M, finals = random_tables(rng, S, C)
    ids = rng.integers(0, C, (T, B)).astype(np.int32)
    return rng, M, finals, ids


@pytest.mark.parametrize("S,C", [(4, 3), (7, 8), (16, 5)])
@pytest.mark.parametrize("B,T", [(1, 9), (8, 33), (13, 17)])
@pytest.mark.parametrize("eps", [3, 7])
def test_cea_scan_equals_reference(S, C, B, T, eps):
    rng, M, finals, ids = scan_case(S, C, B, T, eps,
                                    S * 1000 + B * 10 + eps)
    W = j_ops.ring_size(eps)
    c0 = (rng.random((B, W, S)) < 0.1).astype(np.float32)
    m_j, c_j = j_ops.cea_scan(jnp.asarray(ids), jnp.asarray(M),
                              jnp.asarray(finals), jnp.asarray(c0),
                              epsilon=eps, start_pos=5, use_pallas=False)
    m_t, c_t = t_ops.cea_scan(torch.from_numpy(ids), torch.from_numpy(M),
                              torch.from_numpy(finals),
                              torch.from_numpy(c0), epsilon=eps, start_pos=5)
    equal(m_t, m_j)
    equal(c_t, c_j)


@pytest.mark.parametrize("S,C,B,T,eps", [(4, 3, 8, 9, 3), (7, 8, 3, 12, 7)])
def test_cea_scan_equals_pallas_interpret(S, C, B, T, eps):
    _, M, finals, ids = scan_case(S, C, B, T, eps, S + C + B)
    c0 = np.zeros((B, j_ops.ring_size(eps), S), np.float32)
    m_j, c_j = j_ops.cea_scan(jnp.asarray(ids), jnp.asarray(M),
                              jnp.asarray(finals), jnp.asarray(c0),
                              epsilon=eps, use_pallas=True, interpret=True)
    m_t, c_t = t_ops.cea_scan(torch.from_numpy(ids), torch.from_numpy(M),
                              torch.from_numpy(finals),
                              torch.from_numpy(c0), epsilon=eps)
    equal(m_t, m_j)
    equal(c_t, c_j)


@pytest.mark.parametrize("init_state", [1, 2])
def test_cea_scan_init_state(init_state):
    _, M, finals, ids = scan_case(6, 4, 3, 20, 5, 77)
    c0 = np.zeros((3, 8, 6), np.float32)
    m_j, _ = j_ops.cea_scan(jnp.asarray(ids), jnp.asarray(M),
                            jnp.asarray(finals), jnp.asarray(c0), epsilon=5,
                            init_state=init_state, use_pallas=False)
    m_t, _ = t_ops.cea_scan(torch.from_numpy(ids), torch.from_numpy(M),
                            torch.from_numpy(finals), torch.from_numpy(c0),
                            epsilon=5, init_state=init_state)
    equal(m_t, m_j)


def multi_case(S, C, B, T, NQ, seed):
    rng = np.random.default_rng(seed)
    M, _ = random_tables(rng, S, C)
    finals = (rng.random((NQ, S)) < 0.4).astype(np.float32)
    finals[:, 0] = 0.0
    init = np.zeros(S, np.float32)
    init[rng.choice(np.arange(1, S), size=min(NQ, S - 1), replace=False)] = 1
    ids = rng.integers(0, C, (T, B)).astype(np.int32)
    return rng, M, finals, init, ids


@pytest.mark.parametrize("S,C,NQ", [(5, 3, 1), (9, 6, 3), (20, 4, 8)])
@pytest.mark.parametrize("B,T,eps,start", [(3, 17, 4, 0), (8, 40, 9, 1234)])
def test_cea_scan_multi_equals_reference(S, C, NQ, B, T, eps, start):
    rng, M, finals, init, ids = multi_case(S, C, B, T, NQ, S * 7 + B)
    W = eps + 1 + (3 if start else 0)
    c0 = (rng.random((B, W, S)) < 0.1).astype(np.float32)
    c0[:, :, 0] = 0.0
    m_j, c_j = j_ops.cea_scan_multi(
        jnp.asarray(ids), jnp.asarray(M), jnp.asarray(finals),
        jnp.asarray(c0), init_mask=jnp.asarray(init), epsilon=eps,
        start_pos=start, use_pallas=False)
    m_t, c_t = t_ops.cea_scan_multi(
        torch.from_numpy(ids), torch.from_numpy(M), torch.from_numpy(finals),
        torch.from_numpy(c0), init_mask=torch.from_numpy(init), epsilon=eps,
        start_pos=start)
    equal(m_t, m_j)
    equal(c_t, c_j)


def test_cea_scan_multi_equals_pallas_interpret():
    _, M, finals, init, ids = multi_case(6, 4, 8, 10, 2, 3)
    c0 = np.zeros((8, 8, 6), np.float32)
    m_j, c_j = j_ops.cea_scan_multi(
        jnp.asarray(ids), jnp.asarray(M), jnp.asarray(finals),
        jnp.asarray(c0), init_mask=jnp.asarray(init), epsilon=5,
        start_pos=3, use_pallas=True, interpret=True)
    m_t, c_t = t_ops.cea_scan_multi(
        torch.from_numpy(ids), torch.from_numpy(M), torch.from_numpy(finals),
        torch.from_numpy(c0), init_mask=torch.from_numpy(init), epsilon=5,
        start_pos=3)
    equal(m_t, m_j)
    equal(c_t, c_j)


@pytest.mark.parametrize("multi", [False, True])
def test_scan_chunked_carry(multi):
    """One scan of T events equals two chunks with the ring carried, the
    first at start 0 (early expire indices are negative there)."""
    rng, M, finals, init, ids = multi_case(6, 4, 4, 24, 2, 5)
    W, eps = 8, 5
    c0 = torch.zeros((4, W, 6))

    def scan(lo, hi, c, start):
        t_ids = torch.from_numpy(ids[lo:hi])
        if multi:
            return t_ops.cea_scan_multi(
                t_ids, torch.from_numpy(M), torch.from_numpy(finals), c,
                init_mask=torch.from_numpy(init), epsilon=eps,
                start_pos=start)
        return t_ops.cea_scan(t_ids, torch.from_numpy(M),
                              torch.from_numpy(finals[0]), c, epsilon=eps,
                              start_pos=start)
    m_full, c_full = scan(0, 24, c0, 0)
    m1, c_mid = scan(0, 10, c0, 0)
    m2, c_end = scan(10, 24, c_mid, 10)
    equal(torch.cat([m1, m2]), m_full.numpy())
    equal(c_end, c_full.numpy())
    if multi:
        m_j, _ = j_ops.cea_scan_multi(
            jnp.asarray(ids), jnp.asarray(M), jnp.asarray(finals),
            jnp.zeros((4, W, 6)), init_mask=jnp.asarray(init), epsilon=eps,
            use_pallas=True, interpret=True)
    else:
        m_j, _ = j_ops.cea_scan(jnp.asarray(ids), jnp.asarray(M),
                                jnp.asarray(finals[0]), jnp.zeros((4, W, 6)),
                                epsilon=eps, use_pallas=True, interpret=True)
    equal(m_full, m_j)


def test_scan_ring_padding_exact():
    """Any ring W ≥ ε+1 gives the same matches, whether a multiple of 8
    (the reference's Pallas rings) or not."""
    _, M, finals, init, ids = multi_case(5, 4, 2, 30, 2, 9)
    eps = 4
    outs = []
    for W in (eps + 1, 7, 8, 16):
        c0 = torch.zeros((2, W, 5))
        m, _ = t_ops.cea_scan_multi(
            torch.from_numpy(ids), torch.from_numpy(M),
            torch.from_numpy(finals), c0, init_mask=torch.from_numpy(init),
            epsilon=eps)
        m1, _ = t_ops.cea_scan(torch.from_numpy(ids), torch.from_numpy(M),
                               torch.from_numpy(finals[1]), c0, epsilon=eps)
        outs.append((m.numpy(), m1.numpy()))
    for m, m1 in outs[1:]:
        equal(m, outs[0][0])
        equal(m1, outs[0][1])
    m_j, _ = j_ops.cea_scan_multi(
        jnp.asarray(ids), jnp.asarray(M), jnp.asarray(finals),
        jnp.zeros((2, eps + 1, 5)), init_mask=jnp.asarray(init),
        epsilon=eps)
    equal(outs[0][0], m_j)


def test_scan_inplace_and_refusals():
    _, M, finals, init, ids = multi_case(5, 4, 2, 6, 2, 1)
    args = (torch.from_numpy(ids), torch.from_numpy(M),
            torch.from_numpy(finals))
    c0 = torch.zeros((2, 8, 5))
    m, c = t_ops.cea_scan_multi(*args, c0, init_mask=torch.from_numpy(init),
                                epsilon=5, inplace=True)
    assert c is c0 and float(c0.sum()) > 0
    with pytest.raises(ValueError, match="ring 5 < epsilon"):
        t_ops.cea_scan_multi(*args, torch.zeros((2, 5, 5)),
                             init_mask=torch.from_numpy(init), epsilon=5)
    with pytest.raises(ValueError, match="one scalar start_pos"):
        t_ops.cea_scan_multi(*args, torch.zeros((2, 8, 5)),
                             init_mask=torch.from_numpy(init), epsilon=5,
                             start_pos=torch.zeros(2, dtype=torch.int64))
    # the kernel wrappers check shapes, then refuse CPU tensors, before they
    # build anything
    for kw in (dict(S=513, NQ=1, W=8, epsilon=3), dict(S=5, NQ=0, W=8,
                                                       epsilon=3),
               dict(S=5, NQ=1, W=3, epsilon=3)):
        with pytest.raises(ValueError):
            t_scan.check_launchable(T=4, B=2, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        t_scan.MULTI(*args, torch.zeros((2, 8, 5)), epsilon=5, start=0,
                     init_mask=torch.from_numpy(init))
    with pytest.raises(ValueError, match="CUDA"):
        t_scan.SINGLE(args[0], args[1], args[2][0], torch.zeros((2, 8, 5)),
                      epsilon=5, start=0)


# ---------------------------------------------------------------------------
# cer_pipeline(impl="unfused")
# ---------------------------------------------------------------------------


def pipeline_case(seed, S=6, C=5, A=3, k=4, B=8, T=16, NQ=2):
    rng = np.random.default_rng(seed)
    specs = tuple((int(rng.integers(0, A)), int(rng.integers(0, 6)),
                   float(np.float32(rng.normal()))) for _ in range(k))
    class_of = rng.integers(0, C, 1 << k).astype(np.int32)
    M, _ = random_tables(rng, S, C)
    finals = (rng.random((NQ, S)) < 0.4).astype(np.float32)
    finals[:, 0] = 0.0
    init = np.zeros(S, np.float32)
    init[1] = 1.0
    attrs = rng.normal(size=(T, B, A)).astype(np.float32)
    attrs[rng.random((T, B, A)) < 0.05] = np.nan
    return dict(specs=specs, class_of=class_of, M=M, finals=finals,
                init=init, attrs=attrs, rng=rng, C=C)


def both_pipelines(case, c0, *, j_impl, t_impl, use_pallas, **kw):
    """The JAX and the port's cer_pipeline on the same numpy inputs."""
    C = case["C"]
    j = j_ops.cer_pipeline(
        jnp.asarray(case["attrs"]), case["specs"],
        jnp.asarray(case["class_of"]),
        j_ops.class_indicator(case["class_of"], C), jnp.asarray(case["M"]),
        jnp.asarray(case["finals"]), jnp.asarray(c0),
        init_mask=jnp.asarray(case["init"]), impl=j_impl,
        use_pallas=use_pallas,
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    t = t_ops.cer_pipeline(
        torch.from_numpy(case["attrs"]), case["specs"],
        torch.from_numpy(case["class_of"]),
        t_ops.class_indicator(case["class_of"], C),
        torch.from_numpy(case["M"]), torch.from_numpy(case["finals"]),
        torch.from_numpy(c0.copy()), init_mask=torch.from_numpy(case["init"]),
        impl=t_impl,
        **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    return j, t


@pytest.mark.parametrize("return_trace", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_unfused_pipeline_equals_reference(return_trace, use_pallas):
    case = pipeline_case(11 + use_pallas)
    eps, W = 5, 8
    c0 = (case["rng"].random((8, W, 6)) < 0.05).astype(np.float32)
    j, t = both_pipelines(case, c0, j_impl="unfused", t_impl="unfused",
                          use_pallas=use_pallas, epsilon=eps, start_pos=13,
                          return_trace=return_trace)
    assert len(j) == len(t) == (3 if return_trace else 2)
    for a, b in zip(t, j):
        equal(a, b)
    # the port's fused plain version gives the same
    _, f = both_pipelines(case, c0, j_impl="ref", t_impl="fused",
                          use_pallas=False, epsilon=eps, start_pos=13,
                          return_trace=return_trace)
    for a, b in zip(t, f):
        assert torch.equal(a, b)


def test_unfused_pipeline_inplace():
    case = pipeline_case(4)
    c0 = torch.zeros((8, 8, 6))
    m, c = t_ops.cer_pipeline(
        torch.from_numpy(case["attrs"]), case["specs"],
        torch.from_numpy(case["class_of"]),
        t_ops.class_indicator(case["class_of"], case["C"]),
        torch.from_numpy(case["M"]), torch.from_numpy(case["finals"]), c0,
        init_mask=torch.from_numpy(case["init"]), epsilon=5,
        impl="unfused", inplace=True)
    assert c is c0 and float(c0.sum()) > 0


@pytest.mark.parametrize("what", ["per_lane", "valid", "latest", "consume",
                                  "time"])
def test_unfused_other_calls_take_the_plain_version_on_cpu(what):
    """Calls the scan kernels do not take run the plain version on the CPU
    (the reference package routes them to its XLA path)."""
    case = pipeline_case(21, B=4, T=12)
    rng = case["rng"]
    kw = {}
    if what == "time":
        Jw, Tw = JWindow.time(6.0, max_window_events=16), \
            TWindow.time(6.0, max_window_events=16)
        ts = np.cumsum(rng.integers(0, 3, (12, 4)), axis=0).astype(
            np.float32)
        c0 = {"C": np.zeros((4, 16, 6), np.float32),
              "ts": np.full((4, 16), -np.inf, np.float32),
              "ovf": np.zeros(4, bool)}
        j = j_ops.cer_pipeline(
            jnp.asarray(case["attrs"]), case["specs"],
            jnp.asarray(case["class_of"]),
            j_ops.class_indicator(case["class_of"], case["C"]),
            jnp.asarray(case["M"]), jnp.asarray(case["finals"]),
            {k: jnp.asarray(v) for k, v in c0.items()},
            init_mask=jnp.asarray(case["init"]), window=Jw,
            event_ts=jnp.asarray(ts), impl="unfused", use_pallas=False)
        t = t_ops.cer_pipeline(
            torch.from_numpy(case["attrs"]), case["specs"],
            torch.from_numpy(case["class_of"]),
            t_ops.class_indicator(case["class_of"], case["C"]),
            torch.from_numpy(case["M"]), torch.from_numpy(case["finals"]),
            {k: torch.from_numpy(v.copy()) for k, v in c0.items()},
            init_mask=torch.from_numpy(case["init"]), window=Tw,
            event_ts=torch.from_numpy(ts), impl="unfused")
        equal(t[0], j[0])
        for k in c0:
            equal(t[1][k], j[1][k])
        return
    if what == "per_lane":
        kw["start_pos"] = rng.integers(0, 50, 4).astype(np.int32)
    elif what == "valid":
        kw["valid_counts"] = rng.integers(0, 13, 4).astype(np.int32)
    elif what == "latest":
        kw["latest_q"] = np.asarray([0.0, 1.0], np.float32)
    else:
        kw["consume_sq"] = np.zeros((2, 6), np.float32)
        kw["consume_sq"][0] = 1.0
    c0 = np.zeros((4, 8, 6), np.float32)
    j, t = both_pipelines(case, c0, j_impl="unfused", t_impl="unfused",
                          use_pallas=False, epsilon=5, **kw)
    for a, b in zip(t, j):
        equal(a, b)
    reason = t_ops.unfused_refusal(
        TWindow.events(5), kw.get("start_pos", 0), kw.get("valid_counts"),
        kw.get("latest_q"), kw.get("consume_sq"))
    assert reason is not None


# ---------------------------------------------------------------------------
# VectorEngine.classify / scan
# ---------------------------------------------------------------------------

QUERY = "SELECT * FROM S WHERE A1 ; A2+ ; A3 WITHIN 11 events"


def test_engine_classify_and_scan_equal_reference():
    B, T = 3, 24
    je = JVector(QUERY, use_pallas=False)
    te = TVector(QUERY, device="cpu")
    j_ss = [j_random(JSpec(["A1", "A2", "A3"], seed=b), 2 * T)
            for b in range(B)]
    t_ss = [t_random(TSpec(["A1", "A2", "A3"], seed=b), 2 * T)
            for b in range(B)]
    j_state, t_state = je.init_state(B), te.init_state(B)
    p_state = te.init_state(B)
    for lo in (0, T):
        j_attrs = je.encode([s[lo:lo + T] for s in j_ss])
        t_attrs = te.encode([s[lo:lo + T] for s in t_ss])
        j_ids, t_ids = je.classify(j_attrs), te.classify(t_attrs)
        assert t_ids.dtype == torch.int32
        equal(t_ids, j_ids)
        j_m, j_state = je.scan(j_ids, j_state, start_pos=lo)
        t_m, t_state = te.scan(t_ids, t_state, start_pos=lo)
        equal(t_m, j_m)
        equal(t_state, j_state)
        # the single-dispatch pipeline agrees
        p_m, p_state = te.pipeline(t_attrs, p_state, start_pos=lo)
        assert torch.equal(p_m, t_m)


@pytest.mark.parametrize("query,match", [
    ("SELECT * FROM S WHERE SELL ; BUY WITHIN 30 seconds", "scan()"),
    ("SELECT LAST * FROM S WHERE A1 ; A2 WITHIN 9 events", "LAST"),
    ("SELECT * FROM S WHERE A1 ; A2 WITHIN 9 events CONSUME BY ANY",
     "CONSUME"),
])
def test_engine_scan_refusals_equal_reference(query, match):
    je = JVector(query, use_pallas=False)
    te = TVector(query, device="cpu")
    ids = np.zeros((4, 2), np.int32)
    with pytest.raises(ValueError, match=match) as j_err:
        je.scan(jnp.asarray(ids), je.init_state(2))
    with pytest.raises(ValueError, match=match):
        te.scan(torch.from_numpy(ids), te.init_state(2))
    if match != "scan()":
        with pytest.raises(ValueError) as t_err:
            te.scan(torch.from_numpy(ids), te.init_state(2))
        assert str(t_err.value) == str(j_err.value)


def test_streaming_unfused_on_cpu_equals_fused():
    """A StreamingVectorEngine(impl="unfused") on the CPU feeds the same
    counts, hits and ring as the fused route; no library is loaded."""
    from repro_torch.vector import StreamingVectorEngine
    B, T = 3, 16
    te = TVector(QUERY, device="cpu")
    ss = [t_random(TSpec(["A1", "A2", "A3"], seed=b), 3 * T)
          for b in range(B)]
    un = StreamingVectorEngine(te, T, B, impl="unfused")
    fu = StreamingVectorEngine(TVector(QUERY, device="cpu"), T, B)
    for lo in range(0, 3 * T, T):
        part = [s[lo:lo + T] for s in ss]
        cu, hu = un.feed(part)
        cf, hf = fu.feed(part)
        np.testing.assert_array_equal(cu, cf)
        assert hu == hf
    assert torch.equal(un.state, fu.state)
    assert un.compile_count == 0
