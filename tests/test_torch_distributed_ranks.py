"""The port's distributed CER at 1, 2 and 4 gloo ranks against the
reference package, on the CPU, with exact equality.

Ranks are spawned processes (``torch.multiprocessing``, the ``spawn``
method) joined through a file store in a temporary directory; each runs
``tests/_dist_ranks.py`` on its block and gathers the outputs in rank
order.  The reference's routers run at the same shard counts in one JAX
subprocess with four host devices (``tests/_dist_reference.py``); the
sharded scans are held against ``repro``'s local ``ops``.  At 2 ranks the
processes also restore a world-1 checkpoint as their blocks
(``restore_resharded``) and run the dry run (``--device cpu``).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import _dist_ranks as dr
from repro.kernels import ops as jops

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 180
CASES = {"route": ("routed", "payload", "keep"),
         "route_plain": ("routed", "keep"),
         "chunk": ("attrs", "keys", "positions", "valid", "keep"),
         "chunk_ts": ("attrs", "keys", "positions", "ts", "valid", "keep")}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("reference") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    out = subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "_dist_reference.py"),
                          str(path)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


def _checkpoint(directory: Path) -> dict:
    """A world-1 checkpoint of a partitioned engine's lane state."""
    from repro_torch.checkpoint import CheckpointManager
    rng = np.random.default_rng(4)
    tree = {"state": {"C": rng.integers(0, 9, (8, 16, 5)).astype(np.float32),
                      "lane_keys": rng.integers(0, 2 ** 32, 8,
                                                dtype=np.uint64).astype(
                          np.uint32)},
            "w": np.arange(6.0, dtype=np.float32)}
    CheckpointManager(str(directory)).save(7, tree, extra={"step": 7})
    return tree


def _spawn(n: int, work: Path):
    """Every rank's npz of a run at ``n`` ranks, and the checkpointed tree
    (at 2 ranks)."""
    ckpt, tree = "", None
    if n == 2:
        ckpt = str(work / "ckpt")
        tree = _checkpoint(Path(ckpt))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dr.rank_main, args=(r, n, str(work), ckpt))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = [(work / f"rank{r}.err").read_text() for r in range(n)
            if (work / f"rank{r}.err").exists()]
    assert not any(alive), f"ranks still running after {JOIN_S} s"
    assert not errs and all(p.exitcode == 0 for p in procs), errs
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(n)], tree


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(n)``: the outputs of one run at ``n`` ranks, shared by the
    module's tests."""
    runs = {}

    def run(n: int):
        if n not in runs:
            runs[n] = _spawn(n, tmp_path_factory.mktemp(f"ranks{n}"))
        return runs[n]
    return run


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("case", ["route", "chunk"])
def test_router_matches_reference(case, n, reference, ranks):
    """Routed rows, payloads, valid and keep (gathered in rank order) ≡
    ``repro``'s at the same shard count, spills past capacity included."""
    got = ranks(n)[0][0]
    for sub in (case, case + ("_plain" if case == "route" else "_ts")):
        for name in CASES[sub]:
            want = reference[f"{n}/{sub}/{name}"]
            have = got[f"{sub}/{name}"]
            assert have.dtype == want.dtype, (sub, name, have.dtype)
            np.testing.assert_array_equal(have, want, err_msg=f"{sub}/{name}")
    keep = got[f"{case}/keep"]
    if n > 1:
        dropped = (dr.router_inputs(n)["drop"] if case == "route" else
                   dr.chunk_inputs(n)["keys"] == np.uint32(dr.NULL_KEY_HASH))
        assert (~keep & ~dropped).any(), "a bucket spills past its capacity"


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_scans_match_reference_local_ops(n, ranks):
    """sharded_cea_scan and sharded_cer_pipeline over n ranks, gathered ≡
    ``repro``'s unsharded ``ops.cea_scan`` and ``ops.cer_pipeline``."""
    got = ranks(n)[0][0]
    s = dr.scan_inputs()
    W = jops.ring_size(dr.SCAN_EPS)
    c0 = jnp.zeros((8, W, s["m_all"].shape[1]), jnp.float32)
    m, c = jops.cea_scan(jnp.asarray(s["ids"]), jnp.asarray(s["m_all"]),
                         jnp.asarray(s["finals"]), c0, epsilon=dr.SCAN_EPS,
                         use_pallas=False)
    np.testing.assert_array_equal(got["scan/matches"], np.asarray(m))
    np.testing.assert_array_equal(got["scan/ring"], np.asarray(c))
    class_of = jnp.asarray(s["class_of"])
    m, c = jops.cer_pipeline(
        jnp.asarray(s["attrs"]), dr._specs(s["specs"]), class_of,
        jops.class_indicator(s["class_of"], s["m_all"].shape[0]),
        jnp.asarray(s["m_all"]), jnp.asarray(s["finals"])[None, :], c0,
        init_mask=jnp.asarray(s["init_mask"]), epsilon=dr.PIPE_EPS,
        start_pos=dr.PIPE_START, impl="ref")
    np.testing.assert_array_equal(got["pipe/matches"], np.asarray(m))
    np.testing.assert_array_equal(got["pipe/ring"], np.asarray(c))
    assert got["scan/matches"].sum() > 0 and got["pipe/matches"].sum() > 0


def test_restore_resharded_onto_two_ranks(ranks):
    """A world-1 checkpoint restored onto 2 ranks: each holds its block of
    the lane-indexed leaves, and the whole of the replicated one."""
    outs, tree = ranks(2)
    for r, got in enumerate(outs):
        lanes = slice(4 * r, 4 * r + 4)
        np.testing.assert_array_equal(got["restore/C"],
                                      tree["state"]["C"][lanes])
        assert got["restore/lane_keys"].dtype == np.uint32
        np.testing.assert_array_equal(got["restore/lane_keys"],
                                      tree["state"]["lane_keys"][lanes])
        np.testing.assert_array_equal(got["restore/w"], tree["w"])
        assert int(got["restore/extra_step"]) == 7


def test_cer_dryrun_at_two_ranks(ranks):
    """The dry run under the variables torchrun sets, 2 ranks on the CPU:
    each rank scans its half of the partitions and routes 8 events, 4 to
    each rank, in one all_to_all of 2 buckets of 4 rows."""
    outs, _ = ranks(2)
    for r, got in enumerate(outs):
        d = {k[4:]: int(v) for k, v in got.items() if k.startswith("dry/")}
        assert (d["rank"], d["world"], d["B_local"], d["T"]) == (r, 2, 32,
                                                                 32)
        assert d["state_bytes"] == 32 * d["W"] * d["S"] * 4
        assert d["all_to_all_bytes_sent"] == 2 * 4 * 4 * 4
        assert d["router_rows"] == 8 and 0 < d["router_kept"] <= 8
        assert d["matches"] >= 0
