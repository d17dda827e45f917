"""Rank processes of the port's production-mesh tests
(``tests/test_torch_sharding.py``, ``test_torch_mesh_train.py``) on gloo.

JAX-free: the spawned ranks import this module, and so does the JAX
subprocess that computes the reference's values on the same inputs
(``tests/_mesh_reference.py``).  Inputs are numpy arrays in
``work/inputs.npz`` (the reference's initial weights, flattened with
``/``, and the batches); each rank runs the port and writes what the test
compares to ``<kind>_rank<r>.npz`` (``<kind>_rank<r>.err`` on failure).
"""
import os
import traceback
from datetime import timedelta

import numpy as np

TIMEOUT = timedelta(seconds=60)
JOIN_S = 240
ARCH = "qwen2.5-14b"
# the optimizer of tests/test_torch_train.py: eps 1e-6 keeps directions
# of near-zero gradients apart by less than 1e-3 of the learning rate
OPT = dict(warmup_steps=1, total_steps=100, eps=1e-6)
MOE_ARCH = "granite-moe-1b-a400m"
# (arch, mesh) of the train cases: data 2 × model 2, pod 2 × data 1 ×
# model 2 (pods hold replicas), and the MoE arch's experts over model
TRAIN_CASES = [(ARCH, {"data": 2, "model": 2}),
               (ARCH, {"pod": 2, "data": 1, "model": 2}),
               (MOE_ARCH, {"data": 2, "model": 2})]
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 16, 2
# greedy decode: the dense decoder, Mamba2 with a shared attention block,
# MLA with MoE layers
SERVE_ARCHS = [ARCH, "zamba2-2.7b", "deepseek-v3-671b"]
SERVE_MESH = {"data": 1, "model": 2}
# (arch, mesh) of a train step on 4 ranks against one rank: the
# recurrences over batch and heads, and attention whose 8 query heads
# split over 4 ranks while its 2 key heads stay whole
GRAD_CASES = [("rwkv6-1.6b", {"data": 2, "model": 2}),
              ("zamba2-2.7b", {"data": 2, "model": 2}),
              ("qwen3-32b", {"data": 1, "model": 4})]
SERVE_B, SERVE_PROMPT, SERVE_TOKENS = 2, 6, 6
PIPE_MESH = {"pod": 2, "data": 1, "model": 1}
PIPE_MICRO, PIPE_B, PIPE_S = 3, 2, 8
# (mesh, global shape, spec) cases of the local-block test
BLOCK_CASES = [
    ({"data": 2, "model": 2}, (8, 6), ("data", "model")),
    ({"data": 2, "model": 2}, (8, 6), ("model", None)),
    ({"data": 2, "model": 2}, (4, 8, 10), (None, ("data", "model"), None)),
    ({"pod": 2, "data": 2, "model": 1}, (8, 3), (("pod", "data"), None)),
    ({"pod": 2, "data": 2, "model": 1}, (6, 8), (None, ("pod", "data"))),
]


def params_key(arch: str) -> str:
    """The prefix of ``arch``'s initial weights in ``inputs.npz``."""
    return "params" if arch == ARCH else f"params:{arch}"


def block_input(i: int) -> np.ndarray:
    shape = BLOCK_CASES[i][1]
    return np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)


def unflatten(flat: dict, prefix: str) -> dict:
    """``prefix/a/b`` keys of ``flat`` → a nested dict of arrays."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        if parts[0] != prefix:
            continue
        node = tree
        for part in parts[1:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def _group(work: str, kind: str, rank: int, world: int):
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, f"{kind}_store"),
        rank=rank, world_size=world, timeout=TIMEOUT)


def _run(kind: str, body, rank: int, world: int, work: str) -> None:
    try:
        import torch.distributed as dist
        _group(work, kind, rank, world)
        try:
            out = body(rank, work)
        finally:
            dist.destroy_process_group()
        np.savez(os.path.join(work, f"{kind}_rank{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(work, f"{kind}_rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _model(work: str, arch: str):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import params_from_jax
    inputs = dict(np.load(os.path.join(work, "inputs.npz")))
    cfg = get_smoke_config(arch)
    return params_from_jax(unflatten(inputs, params_key(arch)), cfg,
                           "cpu"), inputs


# ---------------------------------------------------------------------------
# local blocks, the constraint and the mesh's groups (4 ranks)
# ---------------------------------------------------------------------------


def _blocks(rank: int, work: str) -> dict:
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import init_model_mesh
    from repro_torch.sharding import TRAIN_RULES, placements, set_rules
    from repro_torch.sharding import with_logical_constraint as wlc
    from repro_torch.sharding.specs import reshape, to_dtensor
    out = {}
    meshes = {}
    for i, (shape, _, spec) in enumerate(BLOCK_CASES):
        key = tuple(shape.items())
        if key not in meshes:
            meshes[key] = init_model_mesh(shape, rank)
        dm = meshes[key].device_mesh
        x = torch.from_numpy(block_input(i))
        out[f"block/{i}"] = to_dtensor(x, dm, placements(spec, dm)
                                       ).to_local().numpy()
    mesh = meshes[tuple({"data": 2, "model": 2}.items())]
    dm = mesh.device_mesh
    out["groups_from_mesh"] = np.array(all(
        mesh.groups[n] is dm.get_group(n) for n in ("data", "model")))
    out["coords"] = np.array([mesh.axis_index("data"),
                              mesh.axis_index("model")])
    # the constraint: residual stream (batch, seq, d_model) under
    # TRAIN_RULES → batch over data, seq over model
    x = torch.arange(4 * 6 * 5, dtype=torch.float32).reshape(4, 6, 5)
    xd = DTensor.from_local(x, dm, placements((), dm))
    with set_rules(TRAIN_RULES):
        y = wlc(xd, ("batch", "seq", "d_model"))
        z = wlc(xd, ("batch", "seq"))            # not every dim: identity
    out["constraint/placements"] = np.array([str(p) for p in y.placements])
    out["constraint/local"] = y.to_local().numpy()
    out["constraint/full"] = y.full_tensor().numpy()
    out["constraint/short_is_identity"] = np.array(z is xd)
    # 5 heads over a model axis of 2: the split is made whole first
    w = to_dtensor(torch.arange(2 * 3 * 10, dtype=torch.float32).reshape(
        2, 3, 10), dm, placements((None, None, "model"), dm))
    r = reshape(w, 2, 3, 5, 2)
    out["reshape/full"] = r.full_tensor().numpy()
    return out


def blocks_rank_main(rank: int, world: int, work: str) -> None:
    _run("blocks", _blocks, rank, world, work)


# ---------------------------------------------------------------------------
# two train steps on data 2 × model 2 (TRAIN_RULES)
# ---------------------------------------------------------------------------


def _train(rank: int, work: str) -> dict:
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import init_model_mesh, use_model_mesh
    from repro_torch.launch.specs import batch_axes
    from repro_torch.models import make_train_step, state_tree
    from repro_torch.models.convert import tree_to_numpy
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding import TRAIN_RULES, is_dtensor, set_rules
    from repro_torch.sharding.specs import local_bytes, place
    opt = AdamWConfig(**OPT)
    out = {}
    for i, (arch, shape) in enumerate(TRAIN_CASES):
        cfg = get_smoke_config(arch)
        model, inputs = _model(work, arch)
        mesh = init_model_mesh(shape, rank)
        params = dict(model.named_parameters())
        state = {"params": model, "opt": adamw_init(params, opt)}
        axes = model.axes
        state_axes = {"params": axes, "opt": {"mu": axes, "nu": axes,
                                              "step": ()}}
        with set_rules(TRAIN_RULES), use_model_mesh(mesh):
            state = place(state, state_axes, TRAIN_RULES, mesh.device_mesh)
            out[f"{i}/all_dtensor"] = np.array(all(
                is_dtensor(p) for p in state["params"].parameters()))
            out[f"{i}/state_bytes"] = np.int64(local_bytes(state))
            step = make_train_step(cfg, opt)
            for t in range(TRAIN_STEPS):
                batch = {"tokens": torch.from_numpy(
                    inputs[f"tokens/{i}/{t}"])}
                batch = place(batch, batch_axes(cfg), TRAIN_RULES,
                              mesh.device_mesh)
                out[f"{i}/batch_rows"] = np.int64(
                    batch["tokens"].to_local().shape[0])
                state, metrics = step(state, batch)
                for k, v in metrics.items():
                    out[f"{i}/metrics/{t}/{k}"] = np.float64(v)
            tree = tree_to_numpy(state_tree(state, cfg))
        for name in ("params", "mu", "nu"):
            sub = tree["params"] if name == "params" else tree["opt"][name]
            for k, v in _flat(sub).items():
                out[f"{i}/{name}/{k}"] = v
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def train_rank_main(rank: int, world: int, work: str) -> None:
    _run("train", _train, rank, world, work)


# ---------------------------------------------------------------------------
# greedy decode on data 1 × model 2 (DECODE_RULES) and the pipeline on
# pod 2 (2 ranks)
# ---------------------------------------------------------------------------


def _serve_and_pipe(rank: int, work: str) -> dict:
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import init_model_mesh, use_model_mesh
    from repro_torch.launch.pipeline import pipeline_forward, stage_layers
    from repro_torch.launch.serve import generate, place_model
    from repro_torch.sharding import DECODE_RULES, set_rules
    cfg = get_smoke_config(ARCH)
    model, inputs = _model(work, ARCH)
    out = {}
    # the pipeline first: plain weights, this stage's layers
    mesh = init_model_mesh(PIPE_MESH, rank)
    stage = mesh.axis_index("pod")
    blocks = [model.blocks[i] for i in stage_layers(cfg.num_layers, 2,
                                                    stage)]
    x = torch.from_numpy(inputs["pipe/x"])
    with torch.no_grad():
        out["pipe/out"] = pipeline_forward(
            blocks, cfg, x, n_micro=PIPE_MICRO, mesh=mesh).numpy()
    mesh = init_model_mesh(SERVE_MESH, rank)
    for j, arch in enumerate(SERVE_ARCHS):
        cfg = get_smoke_config(arch)
        model, _ = _model(work, arch)
        prompt = torch.from_numpy(inputs[f"serve/{j}/prompt"])
        with set_rules(DECODE_RULES), use_model_mesh(mesh):
            model = place_model(model, DECODE_RULES, mesh)
            run = generate(model, cfg, prompt, SERVE_TOKENS)
        out[f"serve/{j}/tokens"] = run.tokens
    return out


def serve_rank_main(rank: int, world: int, work: str) -> None:
    _run("serve", _serve_and_pipe, rank, world, work)


# ---------------------------------------------------------------------------
# one train step on 4 ranks against the plain state (the port alone)
# ---------------------------------------------------------------------------


def _grads(rank: int, work: str) -> dict:
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import (host_model_mesh, init_model_mesh,
                                         use_model_mesh)
    from repro_torch.launch.specs import batch_axes
    from repro_torch.models import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import TRAIN_RULES, full, set_rules
    from repro_torch.sharding.specs import place
    opt = AdamWConfig(**OPT)
    out = {}
    for arch, shape in GRAD_CASES:
        mesh = init_model_mesh(shape, rank)
        cfg = get_smoke_config(arch)
        tokens = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (TRAIN_B, TRAIN_S)))
        runs = {}
        for kind in ("plain", "placed"):
            state, axes = init_train_state(cfg, opt, 0, device="cpu")
            batch = {"tokens": tokens}
            m = mesh if kind == "placed" else host_model_mesh()
            with set_rules(TRAIN_RULES), use_model_mesh(m):
                if kind == "placed":
                    state = place(state, axes, TRAIN_RULES, m.device_mesh)
                    batch = place(batch, batch_axes(cfg), TRAIN_RULES,
                                  m.device_mesh)
                state, metrics = make_train_step(cfg, opt)(state, batch)
                runs[kind] = {n: full(p.detach()) for n, p in
                              state["params"].named_parameters()}
            for k in ("loss", "grad_norm"):
                out[f"{arch}/{kind}/{k}"] = np.float64(metrics[k])
        out[f"{arch}/lr"] = np.float64(metrics["lr"])
        for n, t in runs["plain"].items():
            out[f"{arch}/delta/{n}"] = np.float64(
                (runs["placed"][n] - t).abs().max())
    return out


def grads_rank_main(rank: int, world: int, work: str) -> None:
    _run("grads", _grads, rank, world, work)


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------


def spawn(target, world: int, work: str, kind: str) -> list:
    """Run ``target(rank, world, work)`` in ``world`` spawned processes;
    returns each rank's outputs (raises with the ranks' tracebacks)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, work))
             for r in range(world)]
    for q in procs:
        q.start()
    for q in procs:
        q.join(JOIN_S)
    alive = [q.is_alive() for q in procs]
    for q in procs:
        if q.is_alive():
            q.kill()
            q.join(10)
    errs = [open(os.path.join(work, f"{kind}_rank{r}.err")).read()
            for r in range(world)
            if os.path.exists(os.path.join(work, f"{kind}_rank{r}.err"))]
    assert not any(alive), f"{kind} ranks still running after {JOIN_S} s"
    assert not errs, errs[0]
    codes = [q.exitcode for q in procs]
    assert codes == [0] * world, f"{kind} ranks exited with {codes}"
    return [dict(np.load(os.path.join(work, f"{kind}_rank{r}.npz")))
            for r in range(world)]
