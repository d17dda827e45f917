"""The port's MoE mesh paths (``_moe_sharded``, ``_local_expert_pass``,
``_moe_decode_stationary``) against the reference's on the CPU.

The reference's launchers run under a mesh (``make_host_mesh()``: data 1 ×
model 1), where ``moe_apply`` leaves ``_moe_global`` for the
expert-parallel paths: at 512 tokens or fewer the weights-stationary pass,
which has no capacity, above it the sharded pass with capacity from each
rank's own tokens.  Here, with Granite's and DeepSeek-V3's smoke widths at
their published capacity factor (1.25):

* on the mesh of one rank, the port ≡ the reference's ``moe_apply`` under
  ``make_host_mesh()`` at 4, 32 and 1024 tokens (capacity binding at 1024)
  within 1e-5;
* on 2 × 2 gloo ranks (``tests/_dist_ranks.py``), each rank's batch block
  ≡ the reference's on its 4-virtual-device mesh, run in a subprocess as
  ``tests/test_moe_stationary.py`` runs it;
* the port's serve launcher takes the paths the reference's launcher takes.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _dist_ranks as dr
from repro import configs as rcfgs
from repro.jaxcompat import use_mesh
from repro.launch.mesh import make_host_mesh
from repro.models import moe as rmoe
from repro_torch import configs as tcfgs
from repro_torch.launch.mesh import host_model_mesh, use_model_mesh
from repro_torch.models import moe as tmoe

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
JOIN_S = 180


def both(arch):
    cfg = dr.moe_cfg(rcfgs.get_smoke_config(arch))
    tcfg = dr.moe_cfg(tcfgs.get_smoke_config(arch))
    p, _ = rmoe.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    p = jax.tree.map(np.asarray, p)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p)
    return cfg, tcfg, p, tp


def capacity_binds(cfg, p, x) -> bool:
    """Whether some expert gets more token-choices than its capacity."""
    xf = x.reshape(-1, cfg.d_model)
    logits = xf @ p["router"]["w"]
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.moe.top_k]
    counts = np.bincount(top.ravel(), minlength=cfg.moe.num_experts)
    cap = max(1, int(cfg.moe.capacity_factor * xf.shape[0] *
                     cfg.moe.top_k / cfg.moe.num_experts))
    return bool((counts > cap).any())


@pytest.mark.parametrize("arch", dr.MOE_ARCHS)
@pytest.mark.parametrize("B,S", dr.MOE_SHAPES)
def test_one_rank_mesh_matches_reference_launcher_moe(arch, B, S):
    cfg, tcfg, p, tp = both(arch)
    x = dr.moe_x(cfg, B, S, p["router"]["w"])
    with use_mesh(make_host_mesh()):
        y, aux = jax.jit(lambda pp, xx: rmoe.moe_apply(pp, cfg, xx))(
            p, jnp.asarray(x))
    with use_model_mesh(host_model_mesh()):
        ty, taux = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=0, atol=TOL)
    assert abs(float(taux) - float(aux)) <= TOL * float(aux)
    path, cap = tmoe.moe_path(tcfg, B, S, host_model_mesh())
    assert path == ("stationary" if B * S <= 512 else "sharded")
    yg, _ = rmoe._moe_global(p, cfg, jnp.asarray(x))
    if B * S == 4:
        # a decode step: the stationary pass drops nothing, where the
        # off-mesh path at capacity 1 drops most choices
        assert float(np.abs(np.asarray(yg) - np.asarray(y)).max()) > 0.1
    if B * S == 1024:
        assert cap == int(1.25 * 1024 * cfg.moe.top_k
                          / cfg.moe.num_experts)
        assert capacity_binds(cfg, p, x)
    # off the mesh the port is the off-mesh path
    ty0, _ = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert tmoe.moe_path(tcfg, B, S)[0] == "global"
    if B * S == 4:
        assert float(np.abs(ty0.numpy() - ty.numpy()).max()) > 0.1


def test_mesh_of_one_rank_carries_gradients():
    """Training at 1024 tokens goes through the sharded pass; its
    gradient ≡ the reference's under the mesh."""
    arch, (B, S) = "granite_moe_1b", (4, 256)
    cfg, tcfg, p, tp = both(arch)
    x = dr.moe_x(cfg, B, S, p["router"]["w"])

    def ref_loss(pp, xx):
        y, aux = rmoe.moe_apply(pp, cfg, xx)
        return jnp.sum(y * y) * 1e-3 + aux

    with use_mesh(make_host_mesh()):
        gx, gp = jax.jit(jax.grad(ref_loss, argnums=(1, 0)))(
            p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    for v in jax.tree.leaves(tp):
        v.requires_grad_(True)
    with use_model_mesh(host_model_mesh()):
        y, aux = tmoe.moe_apply(tp, tcfg, xt)
    (torch.sum(y * y) * 1e-3 + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=TOL)
    for name in ("wi", "wg", "wo"):
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   np.asarray(gp[name]), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# 2 × 2 ranks
# ---------------------------------------------------------------------------

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    import _dist_ranks as dr
    from repro.configs import get_smoke_config
    from repro.jaxcompat import current_mesh, make_mesh, use_mesh
    from repro.models import moe as moe_mod

    inputs = dict(np.load(sys.argv[1]))
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch in dr.MOE_ARCHS:
        cfg = dr.moe_cfg(get_smoke_config(arch))
        p = {}
        for key, v in inputs.items():
            parts = key.split("/")
            if parts[0] == arch and parts[1] == "p":
                node = p
                for part in parts[2:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = jnp.asarray(v)
        for B, S in dr.MOE_SHAPES:
            x = jnp.asarray(inputs[f"{arch}/x/{B}x{S}"])
            with use_mesh(mesh):
                m = current_mesh() or mesh
                y, aux = jax.jit(lambda pp, xx: moe_mod._moe_sharded(
                    pp, cfg, xx, m))(p, x)
            out[f"{arch}/{B}x{S}/y"] = np.asarray(y)
            out[f"{arch}/{B}x{S}/aux"] = np.float32(aux)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The inputs, the reference on a 2 × 2 mesh of host devices, and the
    four port ranks' outputs."""
    work = tmp_path_factory.mktemp("moe_mesh")
    inputs = {}
    for arch in dr.MOE_ARCHS:
        cfg, _, p, _ = both(arch)
        for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
            path = "/".join(str(getattr(e, "key", e)) for e in k)
            inputs[f"{arch}/p/{path}"] = v
        for B, S in dr.MOE_SHAPES:
            inputs[f"{arch}/x/{B}x{S}"] = dr.moe_x(cfg, B, S,
                                                   p["router"]["w"])
    np.savez(work / "moe_inputs.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", REFERENCE,
                          str(work / "moe_inputs.npz"),
                          str(work / "ref.npz")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    ref = dict(np.load(work / "ref.npz"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dr.moe_rank_main, args=(r, 4, str(work)))
             for r in range(4)]
    for q in procs:
        q.start()
    for q in procs:
        q.join(JOIN_S)
    alive = [q.is_alive() for q in procs]
    for q in procs:
        if q.is_alive():
            q.kill()
            q.join(10)
    errs = [(work / f"moe_rank{r}.err").read_text() for r in range(4)
            if (work / f"moe_rank{r}.err").exists()]
    assert not any(alive), f"ranks still running after {JOIN_S} s"
    assert not errs and all(q.exitcode == 0 for q in procs), errs
    return ref, [dict(np.load(work / f"moe_rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("arch", dr.MOE_ARCHS)
@pytest.mark.parametrize("B,S", dr.MOE_SHAPES)
def test_two_by_two_ranks_match_reference_mesh(arch, B, S, mesh_runs):
    """Rank (data d, model m) returns batch block d of the reference's
    output (the same on both model ranks), and the reference's aux."""
    ref, ranks = mesh_runs
    want = ref[f"{arch}/{B}x{S}/y"]
    b = B // 2
    for r, got in enumerate(ranks):
        d = r // 2
        np.testing.assert_allclose(got[f"{arch}/{B}x{S}/y"],
                                   want[d * b:(d + 1) * b], rtol=0,
                                   atol=TOL, err_msg=f"rank {r}")
        aux = float(ref[f"{arch}/{B}x{S}/aux"])
        assert abs(float(got[f"{arch}/{B}x{S}/aux"]) - aux) <= TOL * aux
        assert str(got[f"{arch}/{B}x{S}/path"]) == (
            "stationary" if B * S <= 512 else "sharded")


# ---------------------------------------------------------------------------
# the serve launchers
# ---------------------------------------------------------------------------


def spy(monkeypatch, module, names, log):
    for name in names:
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            log.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)


def test_serve_launcher_takes_the_reference_launchers_route(monkeypatch,
                                                            capsys):
    """Both launchers with Granite's smoke config (4 lanes, an 8-token
    prompt, 2 steps): every MoE call of the port's takes the stationary
    pass, as the reference's does under its ``make_host_mesh()``."""
    from repro.launch import serve as rserve
    from repro_torch.launch import serve as tserve
    names = ("_moe_global", "_moe_decode_stationary", "_local_expert_pass")
    ref_log, port_log = [], []
    spy(monkeypatch, rmoe, names, ref_log)
    spy(monkeypatch, tmoe, names, port_log)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch",
                                      "granite-moe-1b-a400m", "--smoke",
                                      "--tokens", "2"])
    rserve.main()
    tserve.main(["--arch", "granite-moe-1b-a400m", "--smoke", "--tokens",
                 "2", "--device", "cpu"])
    capsys.readouterr()
    assert set(ref_log) == {"_moe_decode_stationary"}
    assert set(port_log) == {"_moe_decode_stationary"}
    layers = tcfgs.get_smoke_config("granite_moe_1b").num_layers
    assert len(port_log) == 3 * layers          # prefill and two steps
