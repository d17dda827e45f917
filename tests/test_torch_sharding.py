"""The port's sharding layer (``repro_torch.sharding``: the rule tables,
specs, the divisibility fallback, placements over a ``DeviceMesh``, the
activation constraint and the placement trees) against the reference's
``repro.sharding`` on the CPU.

* The tables, and every spec and fallback the rules give every
  logical-axes tuple of every arch's parameters, train state, decode
  caches and batch at the published shapes, on meshes of 1×1, 2×2,
  16×16 and 2×16×16: the port's per-layer tensors take their reference
  leaf's spec without the stacked layer axis.  No device is needed.
* On 4 gloo ranks (``tests/_mesh_ranks.py``) against the reference's
  ``NamedSharding`` on 4 forced host devices (``tests/_mesh_reference.py``,
  a subprocess): rank ``r``'s local block ≡ the ``addressable_shards``
  block of the device at row-major position ``r``, two-axis
  ``("pod", "data")`` entries included; the constraint redistributes by
  the rules; the model mesh takes its groups from its ``DeviceMesh``.
* At one rank the constraint is the identity, and state placed by the
  rules round-trips.
"""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import _mesh_ranks as mr
from repro import configs as rcfgs
from repro import sharding as rsh
from repro.launch import specs as rspecs
from repro.sharding import axis_rules as raxis
from repro_torch import configs as tcfgs
from repro_torch import sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.models.convert import leaf_map
from repro.sharding import specs as rsh_specs
from repro_torch.sharding.specs import (divisible_spec_tree, flat_leaves,
                                        sharding_tree, spec_tree)

ROOT = Path(__file__).resolve().parents[1]
TABLES = ["TRAIN_RULES", "DECODE_RULES", "LONG_DECODE_RULES"]
MESHES = [{"data": 1, "model": 1}, {"data": 2, "model": 2},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
DECODE = dict(batch=128, seq=32768)


@pytest.mark.parametrize("table", TABLES)
def test_rule_tables_are_the_reference_tables(table):
    ref, port = getattr(rsh, table), getattr(tsh, table)
    assert port.rules == ref.rules


def _ref_leaves(tree, axes):
    """(path, shape, axes) of every leaf of the reference's matched
    (ShapeDtypeStruct, axes) trees."""
    fa = flat_leaves(axes)
    out = []

    def go(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                go(v, f"{prefix}{k}.")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                go(v, f"{prefix}{i}.")
        else:
            out.append((prefix[:-1], tuple(t.shape), fa[prefix[:-1]]))
    go(tree, "")
    return out


@pytest.fixture(scope="module")
def trees():
    """Each arch's parameters, caches and batch in both packages, at the
    published shapes (abstract: no allocation)."""
    out = {}
    for arch in rcfgs.ARCHS:
        rcfg, tcfg = rcfgs.get_config(arch), tcfgs.get_config(arch)
        rp, rpa = rspecs.abstract_params(rcfg)
        rc, rca = rspecs.abstract_decode_caches(rcfg, DECODE["batch"],
                                                DECODE["seq"])
        rb = rspecs.batch_specs(rcfg, 256, 4096)
        tp, tpa = tspecs.abstract_params(tcfg)
        tc, tca = tspecs.abstract_decode_caches(tcfg, DECODE["batch"],
                                                DECODE["seq"])
        tb = tspecs.batch_specs(tcfg, 256, 4096)
        out[arch] = dict(
            tcfg=tcfg,
            ref_params=_ref_leaves(rp, rpa), port=(tp, tpa),
            ref_caches=_ref_leaves(rc, rca), port_caches=(tc, tca),
            ref_batch=_ref_leaves(rb, rspecs.batch_axes(rcfg)),
            port_batch=(tb, tspecs.batch_axes(tcfg)))
    return out


@pytest.mark.parametrize("table", TABLES)
def test_specs_and_fallbacks_match_reference(trees, table):
    rrules, trules = getattr(rsh, table), getattr(tsh, table)
    checked = 0
    for arch, t in trees.items():
        # every logical-axes tuple: the same spec
        for _, _, axes in t["ref_params"] + t["ref_caches"] + t["ref_batch"]:
            assert trules.spec(axes) == tuple(rrules.spec(axes)), axes
        model, axes = t["port"]
        # the spec tree of the reference's params axes tree
        assert spec_tree(axes, trules) == _tuples(
            rsh_specs.spec_tree(axes, rrules))
        where = leaf_map(t["tcfg"], dict(model.named_parameters()))
        for sizes in MESHES:
            def ref_div(shape, a):
                return tuple(raxis.divisible_spec(rrules.spec(a), shape,
                                                  sizes))
            ref = {p: ref_div(s, a) for p, s, a in t["ref_params"]}
            port = divisible_spec_tree(model, axes, trules, sizes)
            assert set(port) == set(where)
            for name, spec in port.items():
                leaf, layer = where[name]
                want = ref[leaf]
                if layer >= 0:            # the stacked axis, never sharded
                    assert want[0] is None, (arch, leaf, want)
                    want = want[1:]
                assert spec == want, (arch, table, sizes, name, spec, want)
                checked += 1
            for ref_leaves, (tree, ax) in ((t["ref_caches"],
                                            t["port_caches"]),
                                           (t["ref_batch"],
                                            t["port_batch"])):
                port = flat_leaves(divisible_spec_tree(tree, ax, trules,
                                                       sizes))
                for path, shape, a in ref_leaves:
                    assert port[path] == ref_div(shape, a), (arch, path)
                    checked += 1
    assert checked > 10000


def _tuples(tree):
    """A tree of the reference's PartitionSpecs as plain tuples."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tuples(v) for v in tree]
    return tuple(tree)


def _stand_in_mesh(shape: dict):
    """What ``placements`` reads of a ``DeviceMesh``: its axis names and
    sizes (no process group needed)."""
    return SimpleNamespace(mesh_dim_names=tuple(shape),
                           mesh=torch.empty(tuple(shape.values())))


def test_placements_shard_each_mesh_dim_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _stand_in_mesh({"pod": 2, "data": 16, "model": 16})
    assert tsh.placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert tsh.placements((None, None), mesh) == [Replicate()] * 3
    # a mesh dimension of one rank replicates: one block is the whole
    one = _stand_in_mesh({"data": 1, "model": 4})
    assert tsh.placements(("data", "model"), one) == [Replicate(),
                                                      Shard(1)]
    with pytest.raises(ValueError, match="out of the mesh's order"):
        tsh.placements((("data", "pod"),), mesh)
    # a placement tree: each parameter's divisible spec as placements
    cfg = tcfgs.get_smoke_config("qwen2.5-14b")
    model, axes = tspecs.abstract_params(cfg)
    sizes = {"pod": 2, "data": 16, "model": 16}
    tree = sharding_tree(model, axes, tsh.TRAIN_RULES, mesh)
    specs = divisible_spec_tree(model, axes, tsh.TRAIN_RULES, sizes)
    assert tree.keys() == specs.keys()
    assert all(tree[n] == tsh.placements(specs[n], mesh) for n in tree)
    assert tree["embed.embedding"] == [Replicate(), Shard(1), Shard(0)]


# ---------------------------------------------------------------------------
# 4 gloo ranks against 4 forced host devices
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block_runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("blocks"))
    np.savez(os.path.join(work, "inputs.npz"), unused=np.zeros(1))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    ref = subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                "_mesh_reference.py"),
                            work, "blocks"], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        ranks = mr.spawn(mr.blocks_rank_main, 4, work, "blocks")
    finally:
        _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-4000:]
    return dict(np.load(os.path.join(work, "ref_blocks.npz"))), ranks


@pytest.mark.parametrize("case", range(len(mr.BLOCK_CASES)))
def test_local_blocks_match_reference_shards(block_runs, case):
    ref, ranks = block_runs
    for r in range(4):
        want = ref[f"block/{case}/{r}"]
        got = ranks[r][f"block/{case}"]
        assert got.shape == want.shape, (r, got.shape, want.shape)
        np.testing.assert_array_equal(got, want)


def test_constraint_redistributes_by_the_rules(block_runs):
    _, ranks = block_runs
    x = np.arange(4 * 6 * 5, dtype=np.float32).reshape(4, 6, 5)
    for r, out in enumerate(ranks):
        d, m = out["coords"]
        # batch over data, seq over model (TRAIN_RULES), d_model whole
        assert list(out["constraint/placements"]) == ["S(0)", "S(1)"]
        np.testing.assert_array_equal(out["constraint/local"],
                                      x[2 * d:2 * d + 2, 3 * m:3 * m + 3])
        np.testing.assert_array_equal(out["constraint/full"], x)
        assert bool(out["constraint/short_is_identity"])


def test_model_mesh_takes_groups_from_device_mesh(block_runs):
    _, ranks = block_runs
    for r, out in enumerate(ranks):
        assert bool(out["groups_from_mesh"])
        # row-major: rank d·M + m at (d, m)
        assert tuple(out["coords"]) == (r // 2, r % 2)


def test_reshape_makes_an_unevenly_split_dim_whole(block_runs):
    _, ranks = block_runs
    want = np.arange(60, dtype=np.float32).reshape(2, 3, 5, 2)
    for out in ranks:
        np.testing.assert_array_equal(out["reshape/full"], want)


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_model_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield init_model_mesh({"data": 1, "model": 1}, 0)
    finally:
        dist.destroy_process_group()


def test_constraint_is_the_identity_at_one_rank(one_rank):
    from torch.distributed.tensor import DTensor
    x = torch.randn(2, 3, 4)
    with tsh.set_rules(tsh.TRAIN_RULES):
        assert tsh.with_logical_constraint(x, ("batch", "seq",
                                               "d_model")) is x
        xd = DTensor.from_local(x, one_rank.device_mesh,
                                tsh.placements((), one_rank.device_mesh))
        assert tsh.with_logical_constraint(xd, ("batch", "seq",
                                                "d_model")) is xd
        assert tsh.with_logical_constraint(xd, ("batch",)) is xd


def test_state_placed_by_the_rules_round_trips_at_one_rank(one_rank):
    from repro_torch.models import init_train_state, state_tree
    from repro_torch.models.convert import tree_to_numpy
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding.specs import local_bytes, place
    cfg = tcfgs.get_smoke_config("granite-moe-1b-a400m")
    state, axes = init_train_state(cfg, AdamWConfig(), 0, device="cpu")
    before = tree_to_numpy(state_tree(state, cfg))
    nbytes = local_bytes(state)
    placed = place(state, axes, tsh.TRAIN_RULES, one_rank.device_mesh)
    assert all(tsh.is_dtensor(p) for p in placed["params"].parameters())
    assert all(tsh.is_dtensor(v) for v in placed["opt"]["mu"].values())
    assert local_bytes(placed) == nbytes
    after = tree_to_numpy(state_tree(placed, cfg))
    flat_b, flat_a = _flat_values(before), _flat_values(after)
    assert flat_b.keys() == flat_a.keys()
    for k in flat_b:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])


def _flat_values(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_values(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_values(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}
