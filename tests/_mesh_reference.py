"""The reference package's side of the production-mesh tests, on forced
host devices; run as a separate process (the reference's mesh needs its
device count before JAX starts)::

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/_mesh_reference.py WORK KIND...

``KIND`` is ``blocks`` (each case of ``_mesh_ranks.BLOCK_CASES`` placed by
``NamedSharding``: every device's ``addressable_shards`` block, by the
device's row-major position on the mesh), ``train`` (the jitted train
step on each arch and mesh of ``_mesh_ranks.TRAIN_CASES`` with the
state placed by ``sharding_tree`` under ``TRAIN_RULES``, two steps),
``serve`` (greedy decode of each of ``_mesh_ranks.SERVE_ARCHS`` on data
1 × model 2 under ``DECODE_RULES``, the weights placed by
``sharding_tree``)
or ``pipeline`` (``pipeline_forward`` on pod 2: each device's output
buffer).  Inputs come from ``WORK/inputs.npz``; each kind writes
``WORK/ref_<kind>.npz``.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import _mesh_ranks as mr
from repro.configs import get_smoke_config
from repro.jaxcompat import make_mesh


def _mesh(shape: dict):
    n = int(np.prod(list(shape.values())))
    return make_mesh(tuple(shape.values()), tuple(shape),
                     devices=jax.devices()[:n])


def _rank_of(mesh) -> dict:
    """device id → its row-major position on the mesh (the port's rank)."""
    ids = np.vectorize(lambda d: d.id)(mesh.devices).ravel()
    return {int(i): r for r, i in enumerate(ids)}


def blocks(work: str) -> dict:
    out = {}
    for i, (shape, _, spec) in enumerate(mr.BLOCK_CASES):
        mesh = _mesh(shape)
        x = jax.device_put(jnp.asarray(mr.block_input(i)),
                           NamedSharding(mesh, P(*spec)))
        rank = _rank_of(mesh)
        for sh in x.addressable_shards:
            out[f"block/{i}/{rank[sh.device.id]}"] = np.asarray(sh.data)
    return out


def _flat(tree, prefix=""):
    return {prefix + "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                              for e in k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def train(work: str) -> dict:
    from repro.models import init_train_state, make_train_step
    from repro.optim import AdamWConfig
    from repro.sharding import TRAIN_RULES, set_rules
    from repro.sharding.specs import sharding_tree
    inputs = dict(np.load(os.path.join(work, "inputs.npz")))
    opt = AdamWConfig(**mr.OPT)
    out = {}
    for i, (arch, shape) in enumerate(mr.TRAIN_CASES):
        cfg = get_smoke_config(arch)
        mesh = _mesh(shape)
        with set_rules(TRAIN_RULES), jax.set_mesh(mesh):
            state, axes = init_train_state(cfg, opt, jax.random.PRNGKey(0))
            state = jax.device_put(state, sharding_tree(state, axes,
                                                        TRAIN_RULES, mesh))
            step = jax.jit(make_train_step(cfg, opt))
            for t in range(mr.TRAIN_STEPS):
                batch = {"tokens": jnp.asarray(inputs[f"tokens/{i}/{t}"])}
                batch = jax.device_put(batch, sharding_tree(
                    batch, {"tokens": ("batch", None)}, TRAIN_RULES, mesh))
                state, metrics = step(state, batch)
                for k, v in metrics.items():
                    out[f"{i}/metrics/{t}/{k}"] = np.float64(v)
        out.update(_flat(state["params"], f"{i}/params/"))
        out.update(_flat(state["opt"]["mu"], f"{i}/mu/"))
        out.update(_flat(state["opt"]["nu"], f"{i}/nu/"))
    return out


def serve(work: str) -> dict:
    from repro.launch.serve import grow_caches
    from repro.models import init_params, make_serve_step, prefill
    from repro.sharding import DECODE_RULES, set_rules
    from repro.sharding.specs import sharding_tree
    inputs = dict(np.load(os.path.join(work, "inputs.npz")))
    mesh = _mesh(mr.SERVE_MESH)
    out = {}
    for j, arch in enumerate(mr.SERVE_ARCHS):
        cfg = get_smoke_config(arch)
        prompt = jnp.asarray(inputs[f"serve/{j}/prompt"].astype(np.int32))
        toks = []
        with set_rules(DECODE_RULES), jax.set_mesh(mesh):
            params, axes = init_params(cfg, jax.random.PRNGKey(0))
            params = jax.device_put(params, sharding_tree(
                params, axes, DECODE_RULES, mesh))
            logits, caches = jax.jit(lambda p, b: prefill(p, cfg, b))(
                params, {"tokens": prompt})
            S0 = prompt.shape[1]
            caches = grow_caches(caches, S0 + mr.SERVE_TOKENS)
            step = jax.jit(make_serve_step(cfg))
            tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None]
            for t in range(mr.SERVE_TOKENS):
                logits_t, caches = step(params, tok, caches, S0 + t)
                tok = jnp.argmax(logits_t, axis=-1)[:, None]
                toks.append(np.asarray(tok[:, 0]))
        out[f"serve/{j}/tokens"] = np.stack(toks, axis=1)
    return out


def pipeline(work: str) -> dict:
    from repro.launch.pipeline import pipeline_forward
    from repro.models import init_params
    inputs = dict(np.load(os.path.join(work, "inputs.npz")))
    cfg = get_smoke_config(mr.ARCH)
    mesh = _mesh(mr.PIPE_MESH)
    params, _ = init_params(cfg, jax.random.PRNGKey(0))
    seg = params["segments"][0]
    x = jnp.asarray(inputs["pipe/x"])
    with jax.set_mesh(mesh):
        o = jax.jit(lambda p, h: pipeline_forward(
            p, cfg, h, n_micro=mr.PIPE_MICRO))(seg, x)
    rank = _rank_of(mesh)
    out = {f"pipe/{rank[sh.device.id]}": np.asarray(sh.data)
           for sh in o.addressable_shards}
    out["pipe/global"] = np.asarray(o)
    return out


if __name__ == "__main__":
    work = sys.argv[1]
    for kind in sys.argv[2:]:
        res = {"blocks": blocks, "train": train, "serve": serve,
               "pipeline": pipeline}[kind](work)
        np.savez(os.path.join(work, f"ref_{kind}.npz"), **res)
