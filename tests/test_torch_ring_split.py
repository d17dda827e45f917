"""Where the fused-scan kernel keeps a lane's ring: ``plan_ring`` on the CPU.

``plan_ring`` is the pure function that picks the kernel's mode: the whole
ring in one block's shared memory, the ring split over ``n_split`` blocks
per lane with each share in shared memory, or (LAST and CONSUME BY ANY
with a ring too large) one block reading the ring in global memory.  The
kernel itself runs in ``test_torch_cuda.py`` on a card.  A split changes
no result, so on the CPU ``cer_pipeline(split=...)`` runs the plain version
and must still equal the JAX package's ``impl="ref"`` oracle exactly, and
refuse what the kernel refuses.

The narrow builds' sparse step reads each table as index lists, one byte
a source (``packed_lists``, ``table_lists``), built once per table: here
they must give the tables back exactly, in the layout the kernel reads,
and report a table past the cap, with a weight other than 1, or outside
the 32-state build as dense.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as j_ops
from repro_torch.kernels import fused_scan
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels.fused_scan import (plan_ring, ring_share_bytes,
                                            segments)

# about what one H100 block may take beside the kernel's static arrays
H100_LIMIT = 220_000

# (W, S, timed, smem_limit): phase 1 and phase 9 of chip_smoke.py, the
# D5 CONSUME ring, stock rings of 4096 and 144 k slots, rings that do not
# divide, tight limits
GEOMETRIES = [(3208, 7, False, H100_LIMIT), (3208, 28, False, H100_LIMIT),
              (4001, 15, False, H100_LIMIT), (4096, 9, True, H100_LIMIT),
              (144_000, 9, True, H100_LIMIT), (7, 5, False, 64),
              (13, 28, True, 400), (1000, 1, False, 1000),
              (100, 32, False, 33 * 4 * 7), (2, 3, True, 20)]


@pytest.mark.parametrize("W,S,timed,limit", GEOMETRIES)
def test_default_split_covers_the_ring_and_fits(W, S, timed, limit):
    use_smem, n = plan_ring(W, S, timed, limit, latest=False, consume=False)
    assert use_smem
    segs = segments(W, n)
    assert len(segs) == n
    # contiguous, non-empty, and together exactly [0, W)
    assert segs[0][0] == 0 and segs[-1][1] == W
    assert all(a < b for a, b in segs)
    assert all(segs[i][1] == segs[i + 1][0] for i in range(n - 1))
    covered = np.zeros(W, np.int64)
    for a, b in segs:
        covered[a:b] += 1
    assert (covered == 1).all()
    # every share fits, and one block fewer would not
    assert all(ring_share_bytes(b - a, S, timed) <= limit for a, b in segs)
    if n > 1:
        assert ring_share_bytes(-(-W // (n - 1)), S, timed) > limit
    else:
        assert ring_share_bytes(W, S, timed) <= limit


@pytest.mark.parametrize("latest,consume",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_chip_smoke_geometries(latest, consume):
    # phase 1 (ring 3208, S=7, 90 KB): one block, as before the split
    assert plan_ring(3208, 7, False, H100_LIMIT, latest=latest,
                     consume=consume) == (True, 1)
    # phase 9 (four packed queries, Ŝ=28: 372 KB a lane)
    use_smem, n = plan_ring(3208, 28, False, H100_LIMIT, latest=latest,
                            consume=consume)
    if latest or consume:
        assert (use_smem, n) == (False, 1)
    else:
        assert use_smem and n >= 2


@pytest.mark.parametrize("W,S,timed", [(4001, 15, False), (4000, 26, False),
                                       (144_000, 9, True)])
@pytest.mark.parametrize("latest,consume", [(True, False), (False, True)])
def test_last_and_consume_keep_global_memory(W, S, timed, latest, consume):
    assert ring_share_bytes(W, S, timed) > H100_LIMIT
    assert plan_ring(W, S, timed, H100_LIMIT, latest=latest,
                     consume=consume) == (False, 1)


@pytest.mark.parametrize("W,split,n", [(7, 2, 2), (7, 3, 3), (7, 5, 4),
                                       (10, 6, 5), (3208, 5, 5),
                                       (3208, 8, 8), (9, 9, 9), (1, 1, 1)])
def test_forced_split_is_trimmed_to_non_empty_segments(W, split, n):
    use_smem, got = plan_ring(W, 5, False, H100_LIMIT, latest=False,
                              consume=False, split=split)
    assert use_smem and got == n
    segs = segments(W, got)
    assert segs[-1][1] == W and all(a < b for a, b in segs)
    assert max(b - a for a, b in segs) == -(-W // split)


def test_forced_split_whose_share_does_not_fit_stays_in_global_memory():
    assert plan_ring(3208, 28, False, H100_LIMIT, latest=False,
                     consume=False, split=1) == (False, 1)
    assert plan_ring(3208, 28, False, H100_LIMIT, latest=False,
                     consume=False, split=2) == (True, 2)


@pytest.mark.parametrize("kw,match", [
    (dict(latest=True, consume=False, split=2), "LAST"),
    (dict(latest=False, consume=True, split=2), "CONSUME"),
    (dict(latest=True, consume=True, split=1), "LAST"),
    (dict(latest=False, consume=False, split=41), "1..40"),
    (dict(latest=False, consume=False, split=0), "1..40"),
    (dict(latest=False, consume=False, split=-3), "1..40"),
])
def test_forced_split_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        plan_ring(40, 5, False, H100_LIMIT, **kw)


# ---------------------------------------------------------------------------
# cer_pipeline(split=...) on the CPU: the plain version, against JAX
# ---------------------------------------------------------------------------


def pipeline_case(seed, S=6, C=4, A=2, k=3, B=5, T=24, NQ=2):
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
    return specs, class_of, M, finals, init, attrs, rng


@pytest.mark.parametrize("split", [None, 1, 2, 3, 5])
@pytest.mark.parametrize("start", [0, 17])
def test_split_pipeline_on_cpu_equals_jax(split, start):
    eps, W = 6, 8
    specs, class_of, M, finals, init, attrs, rng = pipeline_case(
        11 + start)
    B, S = attrs.shape[1], M.shape[1]
    c0 = (rng.random((B, W, S)) < 0.1).astype(np.float32)
    c0[:, :, 0] = 0.0
    C = M.shape[0]
    jm, jc = j_ops.cer_pipeline(
        jnp.asarray(attrs), specs, jnp.asarray(class_of),
        j_ops.class_indicator(class_of, C), jnp.asarray(M),
        jnp.asarray(finals), jnp.asarray(c0), init_mask=jnp.asarray(init),
        epsilon=eps, start_pos=start, impl="ref")
    tm, tc = t_ops.cer_pipeline(
        torch.from_numpy(attrs), specs, torch.from_numpy(class_of),
        t_ops.class_indicator(class_of, C), torch.from_numpy(M),
        torch.from_numpy(finals), torch.from_numpy(c0),
        init_mask=torch.from_numpy(init), epsilon=eps, start_pos=start,
        split=split)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("impl", ["fused", "unfused", "ref"])
@pytest.mark.parametrize("what", ["LAST", "CONSUME", "split > W"])
def test_split_refusals_on_every_route(impl, what):
    specs, class_of, M, finals, init, attrs, _ = pipeline_case(3)
    B, S, NQ, W = attrs.shape[1], M.shape[1], finals.shape[0], 8
    kw = dict(split=2)
    if what == "LAST":
        kw["latest_q"] = torch.ones(NQ)
    elif what == "CONSUME":
        kw["consume_sq"] = torch.ones((NQ, S))
    else:
        kw["split"] = W + 1
    launches = fused_scan.KERNEL.launches
    with pytest.raises(ValueError, match="split"):
        t_ops.cer_pipeline(
            torch.from_numpy(attrs), specs, torch.from_numpy(class_of),
            None, torch.from_numpy(M), torch.from_numpy(finals),
            torch.zeros((B, W, S)), init_mask=torch.from_numpy(init),
            epsilon=5, impl=impl, **kw)
    assert fused_scan.KERNEL.launches == launches


# ---------------------------------------------------------------------------
# the sparse step's index lists
# ---------------------------------------------------------------------------

CAP = fused_scan.SPARSE_CAP
NONE = fused_scan.NONE


def capped_table(rng, C, S, deg):
    """(C, S, S) of 0/1 with at most ``deg`` non-zeros in a column, exactly
    ``deg`` in column 0 of class 0 (``deg`` ≤ S)."""
    M = np.zeros((C, S, S), np.float32)
    for c in range(C):
        for u in range(S):
            k = deg if (c, u) == (0, 0) else int(rng.integers(0, deg + 1))
            M[c, rng.choice(S, size=k, replace=False), u] = 1.0
    return M


def unpack(words, R):
    """The 0/1 table (..., R, N) whose columns ``words`` (..., N) list, one
    source a byte as the kernel reads them; checks the bytes ascend and
    that only empty bytes follow an empty byte."""
    w = words.long() & 0xFFFFFFFF
    out = torch.zeros(words.shape[:-1] + (R,) + words.shape[-1:])
    flat_w, flat_o = w.reshape(-1, w.shape[-1]), out.view(-1, R,
                                                          w.shape[-1])
    for i in range(flat_w.shape[0]):
        for n in range(flat_w.shape[1]):
            srcs = [(int(flat_w[i, n]) >> (8 * k)) & 0xFF for k in range(CAP)]
            live = [x for x in srcs if x != NONE]
            assert srcs == live + [NONE] * (CAP - len(live))
            assert live == sorted(set(live))
            for x in live:
                flat_o[i, x, n] = 1.0
    return out


@pytest.mark.parametrize("S,C,deg", [(1, 3, 1), (5, 4, 1), (7, 6, 2),
                                     (16, 3, 3), (28, 5, CAP), (32, 2, 0)])
def test_lists_give_the_tables_back(S, C, deg):
    rng = np.random.default_rng(S * 7 + deg)
    M = torch.from_numpy(capped_table(rng, C, S, deg))
    # up to three queries: columns of a capped table, each ≤ deg finals
    NQ = min(3, S)
    F = torch.from_numpy(capped_table(rng, 1, S, deg)[0, :, :NQ].T.copy())
    words, D = fused_scan.packed_lists(M)
    fwords, DF = fused_scan.packed_lists(F.t())
    # D is the largest column in-degree (at least 1)
    assert words.dtype == fwords.dtype == torch.int32
    assert tuple(words.shape) == (C, S) and D == max(deg, 1)
    assert tuple(fwords.shape) == (NQ,)
    assert DF == max(int((F != 0).sum(1).max()), 1)
    assert torch.equal(unpack(words, S), M)
    assert torch.equal(unpack(fwords, S).t(), F)
    src, w = fused_scan.column_lists(M)
    assert src.shape == (C, max(deg, 1), S) and (w[w != 0] == 1).all()


@pytest.mark.parametrize("where", ["column", "finals", "weight"])
def test_tables_past_the_cap_keep_the_dense_product(where):
    rng = np.random.default_rng(5)
    S = 19
    M = torch.from_numpy(capped_table(rng, 3, S, 2))
    F = torch.zeros((2, S))
    F[:, 1] = 1.0
    if where == "column":
        M[1, :CAP + 1, 4] = 1.0           # one column of CAP + 1 sources
        assert fused_scan.packed_lists(M) is None
    elif where == "finals":
        F[1, 2:CAP + 3] = 1.0             # a query of CAP + 1 final states
        assert fused_scan.packed_lists(F.t()) is None
    else:
        M[2, 3, 5] = 2.0                  # a weight the sum cannot skip
        assert fused_scan.packed_lists(M) is None
    assert fused_scan.table_lists(M, F) is None
    # at the cap itself the lists still take it
    assert fused_scan.column_lists(M[:, :CAP], cap=CAP) is not None


@pytest.mark.parametrize("S,deg,sparse", [(7, 1, False), (16, 1, False),
                                          (17, 1, True), (28, 2, True),
                                          (32, CAP, True), (28, CAP + 1, False),
                                          (40, 1, False)])
def test_only_the_32_state_build_takes_lists(S, deg, sparse):
    """Up to SPARSE_CAP sources a state in the 32-state build; the 8- and
    16-state builds and the wide build keep the dense product."""
    rng = np.random.default_rng(S + deg)
    M = torch.from_numpy(capped_table(rng, 3, S, deg))
    F = torch.zeros((2, S))
    F[:, -1] = 1.0
    assert fused_scan.table_cap(S) == (CAP if 16 < S <= 32 else 0)
    assert (fused_scan.table_lists(M, F) is not None) == sparse


def test_seq3_pack4_tables_take_two_sources_a_state():
    from repro_torch.vector import MultiQueryEngine
    cfg = json.loads((Path(__file__).resolve().parents[1] / "bench" /
                      "configs" / "seq3_pack4.json").read_text())
    qs = [cfg["query"].format(seq=q, window=cfg["window"])
          for q in cfg["queries"]]
    t = MultiQueryEngine(qs, device="cpu").tables
    assert tuple(t.m_all.shape) == (512, 28, 28)
    (words, D), (fwords, DF) = fused_scan.table_lists(t.m_all, t.finals)
    assert (D, DF) == (2, 1)              # two sources a state, one final
    assert tuple(words.shape) == (512, 28) and tuple(fwords.shape) == (4,)
    assert torch.equal(unpack(words[:8], 28), t.m_all[:8])


def test_lists_are_built_once_per_table():
    rng = np.random.default_rng(2)
    M = torch.from_numpy(capped_table(rng, 2, 20, 2))
    F = torch.zeros(20)
    F[3] = 1.0
    first = fused_scan.table_lists(M, F[None, :])
    # a fresh view of the same finals finds the lists kept on its base
    again = fused_scan.table_lists(M, F[None, :])
    assert all(a is b for a, b in zip(first, again))
    M[0, 0, 0] += 0.0                     # an in-place write: built anew
    rebuilt = fused_scan.table_lists(M, F[None, :])
    assert rebuilt[0] is not first[0] and rebuilt[1] is first[1]
    assert torch.equal(rebuilt[0][0], first[0][0])
