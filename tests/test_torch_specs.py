"""The port's abstract inputs, dry run and cost model
(``repro_torch.launch.specs``, ``dryrun``, ``costmodel``) against the
reference's on the CPU.

* ``input_specs`` of every (arch × ``shapes_for``) cell on the ``meta``
  device ≡ the reference's ``jax.eval_shape`` specs: kinds, every leaf's
  shape, dtype and logical axes (the port's per-layer tensors stacked back
  into the reference's leaves), batches, caches, token and index.
* The cost model's ``type_counts`` and ``variants`` ≡ the reference's (its
  module forces 512 devices at import, so it runs in a subprocess).
* On a fake process group of 4 ranks (a subprocess: the fake group is the
  process's default group): the direct count of a cell at a smoke depth ≡
  the extrapolation from the variants (a train, a decode and a prefill
  cell); a cell's record has the
  reference's fields, and its argument bytes per device ≡ the sum of the
  blocks that ``divisible_spec`` gives each leaf; and over a fake 16×16
  mesh a hand-computed matmul pins the FLOPs per device (1/256 of the
  product, where a counter above DTensor sees all of it) and a gather's
  bytes.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.launch import specs as rspecs
from repro_torch import configs as tcfgs
from repro_torch.launch import costmodel as tcost
from repro_torch.launch import specs as tspecs
from repro_torch.models import state_tree
from repro_torch.models.convert import to_reference_tree
from repro_torch.sharding import TRAIN_RULES
from repro_torch.sharding.specs import divisible_spec_tree, flat_leaves

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, JAX_PLATFORMS="cpu",
           PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                       str(ROOT / "tests")]))
ENV.pop("XLA_FLAGS", None)
# the smoke cells of the fake-group subprocess
SMALL = {"train_4k": dict(kind="train", seq_len=16, global_batch=4),
         "prefill_32k": dict(kind="prefill", seq_len=16, global_batch=4),
         "decode_32k": dict(kind="decode", seq_len=16, global_batch=4)}
CELL = ("qwen2.5-14b", "train_4k")


def _leaves(tree, prefix=""):
    """Dotted path → leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)) and not (
            tree and all(a is None or isinstance(a, (str, tuple))
                         for a in tree)) and not (tree == ()):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _sig(x):
    """(shape, dtype name) of a ShapeDtypeStruct or a tensor."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).replace("torch.", "")
    return tuple(x.shape), str(np.dtype(x.dtype))


def _port_tree(cfg, spec):
    """The port's train state or params in the reference's tree (meta
    tensors stacked per segment)."""
    if spec["kind"] == "train":
        return state_tree(spec["state"], cfg)
    named = dict(spec["params"].named_parameters())
    return to_reference_tree(cfg, named)


@pytest.mark.parametrize("arch", rcfgs.ARCHS)
def test_input_specs_match_reference(arch):
    rcfg, tcfg = rcfgs.get_config(arch), tcfgs.get_config(arch)
    assert tcfgs.shapes_for(tcfg) == rcfgs.shapes_for(rcfg)
    for shape in rcfgs.shapes_for(rcfg):
        ref = rspecs.input_specs(rcfg, shape)
        port = tspecs.input_specs(tcfg, shape)
        assert port["kind"] == ref["kind"]
        key = "state" if ref["kind"] == "train" else "params"
        want = {k: _sig(v) for k, v in _leaves(ref[key]).items()}
        got = {k: _sig(v) for k, v in _leaves(_port_tree(tcfg, port)).items()
               if v is not None}
        assert got == want, (arch, shape, set(got) ^ set(want))
        akey = "state_axes" if key == "state" else "param_axes"
        assert _leaves(port[akey]) == _leaves(ref[akey])
        if ref["kind"] == "train":
            assert port["opt_cfg"].moment_dtype == ref["opt_cfg"].moment_dtype
        extra = (("batch", "batch_axes") if ref["kind"] != "decode" else
                 ("caches", "cache_axes", "token", "index"))
        for k in extra:
            if k.endswith("axes"):
                assert _leaves(port[k]) == _leaves(ref[k]), (arch, k)
                continue
            r = {p: _sig(v) for p, v in _leaves(ref[k]).items()}
            t = {p: _sig(v) for p, v in _leaves(port[k]).items()
                 if isinstance(v, torch.Tensor)}
            assert t == r, (arch, shape, k)
        # nothing was allocated: every tensor is on meta
        tensors = [v for v in _leaves(port).values()
                   if isinstance(v, torch.Tensor)]
        tensors += list((port.get("state") or {"params": port["params"]}
                         )["params"].parameters())
        assert all(t.device.type == "meta" for t in tensors)


REF_COST = textwrap.dedent("""
    import dataclasses, json, sys
    from repro.configs import ARCHS, get_config
    from repro.launch import costmodel as cm
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        out[arch] = {"counts": cm.type_counts(cfg),
                     "variants": [[{f: getattr(v, f) for f in
                                    ("num_layers", "shared_attn_every",
                                     "first_dense_layers", "encoder_layers",
                                     "scan_layers")}, c]
                                  for v, c in cm.variants(cfg)]}
    json.dump(out, open(sys.argv[1], "w"))
""")


def test_cost_model_counts_and_variants_match_reference(tmp_path):
    out = subprocess.run([sys.executable, "-c", REF_COST,
                          str(tmp_path / "ref.json")], env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    ref = json.load(open(tmp_path / "ref.json"))
    for arch in tcfgs.ARCHS:
        cfg = tcfgs.get_config(arch)
        assert tcost.type_counts(cfg) == ref[arch]["counts"]
        got = [[{f: getattr(v, f) for f in
                 ("num_layers", "shared_attn_every", "first_dense_layers",
                  "encoder_layers", "scan_layers")}, c]
               for v, c in tcost.variants(cfg)]
        assert got == ref[arch]["variants"], arch


FAKE = textwrap.dedent("""
    import dataclasses, json, os, sys
    import torch
    from repro_torch import configs
    from repro_torch.launch import costmodel, dryrun
    configs.SHAPES.update(json.loads(sys.argv[2]))
    out = {}
    dryrun.fake_world(4)
    mesh = dryrun.make_mesh({"data": 2, "model": 2})
    arch, shape = json.loads(sys.argv[3])
    rec = dryrun.run_cell(arch, shape, mesh, "fake2x2",
                          cfg=configs.get_smoke_config(arch),
                          verbose=False)
    out["record"] = rec
    out["written"] = sorted(os.listdir(dryrun.RESULTS_DIR))
    # direct ≡ extrapolated at a smoke depth
    cases = [("qwen2.5-14b", "train_4k", dict(num_layers=4)),
             ("deepseek-v3-671b", "decode_32k", {}),
             ("rwkv6-1.6b", "prefill_32k", dict(num_layers=5))]
    for arch, shape, kw in cases:
        cfg = dataclasses.replace(configs.get_smoke_config(arch), **kw)
        direct = costmodel.cell_costs(cfg, arch, shape, mesh, "fake2x2")
        x = costmodel.extrapolate(arch, shape, mesh, "fake2x2", cfg=cfg)
        out[f"direct/{arch}"] = direct
        out[f"extrapolated/{arch}"] = x
    # a hand-computed matmul over a fake 16×16 mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    dryrun.fake_world(256)
    mesh = dryrun.make_mesh({"data": 16, "model": 16})
    M, K, N = 1048576, 5120, 13824

    def dt(shape, place):
        local = [s // 16 if any(getattr(p, "dim", None) == d
                                 for p in place) else s
                 for d, s in enumerate(shape)]
        return DTensor.from_local(
            torch.empty(local, dtype=torch.bfloat16, device="meta"), mesh,
            place, run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())
    x = dt((M, K), [Shard(0), Replicate()])
    w = dt((K, N), [Replicate(), Shard(1)])
    mode = dryrun.CostMode()
    with mode:
        y = x @ w
    out["matmul_flops"] = mode.flops
    out["matmul_local"] = list(y.to_local().shape)
    with FlopCounterMode(display=False) as above:
        x @ w
    out["matmul_flops_above"] = above.get_total_flops()
    g = dt((K, N), [Shard(0), Replicate()])
    mode = dryrun.CostMode()
    with mode:
        g.redistribute(mesh, [Replicate(), Replicate()])
    out["gather"] = mode.collectives
    # rank 3 of a fake data 2 × model 2: the weights drawn in place keep
    # the blocks that the whole draw placed by the rules gives
    from repro_torch.models import init_params
    from repro_torch.sharding import TRAIN_RULES
    from repro_torch.sharding.specs import (drawn_in_place, local_block,
                                            sharding_tree)
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=3,
                            world_size=4)
    mesh = dryrun.make_mesh({"data": 2, "model": 2})
    for arch in ("qwen2.5-14b", "granite-moe-1b-a400m"):
        cfg = configs.get_smoke_config(arch)
        whole, axes = init_params(cfg, 0, "cpu")
        where = sharding_tree(whole, axes, TRAIN_RULES, mesh)
        with drawn_in_place(cfg, TRAIN_RULES, mesh):
            drawn, _ = init_params(cfg, 0, "cpu")
        named = dict(whole.named_parameters())
        got = dict(drawn.named_parameters())
        out[f"drawn/{arch}"] = {
            "names": sorted(got) == sorted(named),
            "equal": all(torch.equal(got[n].to_local(), local_block(
                t, mesh, where[n])) for n, t in named.items()),
            "split": sum(got[n].to_local().shape != t.shape
                         for n, t in named.items())}
    json.dump(out, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def fake_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("fake")
    env = dict(ENV, REPRO_RESULTS_DIR=str(work / "dryrun"))
    out = subprocess.run([sys.executable, "-c", FAKE, str(work / "out.json"),
                          json.dumps(SMALL), json.dumps(CELL)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.load(open(work / "out.json"))


def test_direct_count_matches_the_extrapolation(fake_runs):
    for arch in ("qwen2.5-14b", "deepseek-v3-671b", "rwkv6-1.6b"):
        d, x = fake_runs[f"direct/{arch}"], fake_runs[f"extrapolated/{arch}"]
        assert d["flops"] > 0
        for k in d:
            assert x[k] == pytest.approx(d[k], rel=1e-9, abs=1e-3), (arch, k)


REF_FIELDS = ["arch", "shape", "mesh", "kind", "num_devices", "seq_len",
              "global_batch", "params_total", "params_active", "flops",
              "bytes_accessed", "cost_analysis", "memory_analysis",
              "collectives", "hlo_chars", "lower_s", "compile_s"]
COLL = ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"]


def _block_bytes(tree, specs, sizes):
    """Σ over leaves of the bytes of one block of the spec's split."""
    total = 0
    for path, t in _leaves(tree).items():
        if not isinstance(t, torch.Tensor):
            continue
        spec = specs[path]
        n = 1
        for d, s in enumerate(t.shape):
            entry = spec[d] if d < len(spec) else None
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n *= s // math.prod(sizes[a] for a in axes)
        total += n * t.element_size()
    return total


def test_dry_run_record_has_reference_fields_and_shard_bytes(fake_runs):
    rec = fake_runs["record"]
    assert [f for f in REF_FIELDS if f not in rec] == []
    assert rec["num_devices"] == 4 and rec["kind"] == "train"
    assert set(COLL) <= set(rec["collectives"])
    mem = rec["memory_analysis"]
    assert mem["temp_size_in_bytes"] is None
    assert fake_runs["written"] == [f"{CELL[0]}__{CELL[1]}__fake2x2.json"]
    # the argument bytes: each leaf's block under divisible_spec
    arch, shape = CELL
    cfg = tcfgs.get_smoke_config(arch)
    sizes = {"data": 2, "model": 2}
    spec = tspecs.input_specs(cfg, shape)
    state = spec["state"]
    s = dict(SMALL[shape])
    batch = tspecs.batch_specs(cfg, s["global_batch"], s["seq_len"])
    specs = divisible_spec_tree(state, spec["state_axes"], TRAIN_RULES,
                                sizes)
    model_specs = specs["params"]
    want = 0
    named = dict(state["params"].named_parameters())
    want += _block_bytes(named, model_specs, sizes)
    for k in ("mu", "nu"):
        want += _block_bytes(state["opt"][k], specs["opt"][k], sizes)
    want += state["opt"]["step"].element_size()
    want += _block_bytes(batch, flat_leaves(divisible_spec_tree(
        batch, tspecs.batch_axes(cfg), TRAIN_RULES, sizes)), sizes)
    assert mem["argument_size_in_bytes"] == want
    assert rec["flops"] > 0 and rec["collectives"]["all-gather"] > 0


def test_matmul_flops_per_device_are_counted_on_the_local_blocks(fake_runs):
    M, K, N = 1048576, 5120, 13824
    assert fake_runs["matmul_local"] == [M // 16, N // 16]
    assert fake_runs["matmul_flops"] == 2 * (M // 16) * K * (N // 16)
    # a counter above DTensor sees the whole product (256 times as much)
    assert fake_runs["matmul_flops_above"] == 2 * M * K * N
    # gathering a (K, N) bf16 weight split over data: the whole result
    assert fake_runs["gather"]["all-gather"] == K * N * 2
    assert sum(fake_runs["gather"].values()) == K * N * 2


def test_weights_drawn_in_place_keep_this_ranks_blocks(fake_runs):
    for arch in ("qwen2.5-14b", "granite-moe-1b-a400m"):
        got = fake_runs[f"drawn/{arch}"]
        assert got["names"] and got["equal"], arch
        assert got["split"] > 5, arch
