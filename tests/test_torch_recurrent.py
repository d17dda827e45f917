"""The port's recurrent mixers (``repro_torch.models.ssm``: Mamba2's SSD;
``repro_torch.models.rwkv``: RWKV6's WKV) and the Zamba2 and RWKV6 stacks
against the reference package's on the CPU, in float32.

Inputs are drawn with numpy from a seed; weights are the reference's
(``mamba2_init``, ``rwkv6_init``, ``init_params``), carried across as
numpy arrays.  Tolerances: SSD and the mixers 1e-5; the stacks' logits
1e-4 and every cache leaf 1e-5; decode ≡ teacher forcing 5e-4
(``test_archs.py``'s bound).  The reference's stack runs are shared
through module-scoped fixtures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.core import Event as RefEvent
from repro.core import compile_query as ref_compile_query
from repro.launch.serve import grow_caches as ref_grow_caches
from repro.models import decode_step as ref_decode_step
from repro.models import forward_train as ref_forward_train
from repro.models import init_decode_caches as ref_init_decode_caches
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models import rwkv as rrwkv
from repro.models import ssm as rssm
from repro.models import stack as rstack
from repro_torch import configs as tcfgs
from repro_torch.launch import serve
from repro_torch.models import (channel_mix, decode_step, forward_train,
                                init_decode_caches, init_params,
                                params_from_jax, prefill, rwkv, ssm)

ARCHS = ["zamba2_2p7b", "rwkv6_1p6b"]


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def close(a, b, atol):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def leaves(tree, prefix=""):
    """``{path: leaf}`` of a cache tree (dicts and lists)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}/{k}"))
    return out


def close_trees(ref, port, atol):
    """Every leaf of ``port`` ≡ ``ref``'s: the same paths, shapes and
    dtypes, values within ``atol``."""
    a, b = leaves(ref), leaves(port)
    assert sorted(a) == sorted(b)
    for path in a:
        assert str(np.asarray(a[path]).dtype) == \
            str(b[path].dtype).replace("torch.", ""), path
        close(a[path], b[path], atol)


def draw(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def ssm_cfgs(chunk=4):
    cfg = rcfgs.get_smoke_config("zamba2_2p7b")
    tcfg = tcfgs.get_smoke_config("zamba2_2p7b")
    return (dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                             chunk=chunk)),
            dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm,
                                                              chunk=chunk)))


@pytest.mark.parametrize("S,with_state", [(4, False), (16, False),
                                          (12, True), (6, True)],
                         ids=["one_chunk", "four_chunks", "three_chunks_state",
                              "degenerate_state"])
def test_ssd_chunked_matches_reference(S, with_state):
    """``ssd_chunked`` ≡ ``ssd_reference`` in both packages (chunk 4; S=6
    is the degenerate single chunk), from a zero or a given state."""
    cfg, tcfg = ssm_cfgs(chunk=4)
    rng = np.random.default_rng(S)
    B, H, P, N = 2, 3, 8, 5
    xh, Bm, Cm = draw(rng, B, S, H, P), draw(rng, B, S, N), draw(rng, B, S, N)
    dt = np.log1p(np.exp(draw(rng, B, S, H)))
    A_log, D = draw(rng, H, scale=0.5), draw(rng, H)
    state = draw(rng, B, H, P, N) if with_state else None
    args = (xh, dt, Bm, Cm, A_log, D)
    ref = [f(cfg, *map(jnp.asarray, args),
             state=None if state is None else jnp.asarray(state))
           for f in (rssm.ssd_reference, rssm.ssd_chunked)]
    port = [f(tcfg, *map(torch.from_numpy, args),
              state=None if state is None else torch.from_numpy(state))
            for f in (ssm.ssd_reference, ssm.ssd_chunked)]
    for y, st in ref[1:] + port:
        close(ref[0][0], y, 1e-5)
        close(ref[0][1], st, 1e-5)


def test_mamba2_matches_reference():
    """Train, prefill and decode of one Mamba2 mixer, chunked (S=8, chunk
    4), with its conv cache and state."""
    cfg, tcfg = ssm_cfgs(chunk=4)
    p = to_np(rssm.mamba2_init(jax.random.PRNGKey(3), cfg, jnp.float32)[0])
    tp = to_torch(p)
    rng = np.random.default_rng(4)
    x = draw(rng, 2, 8, cfg.d_model)
    close(rssm.mamba2_train(p, cfg, jnp.asarray(x)),
          ssm.mamba2_train(tp, tcfg, torch.from_numpy(x)), 1e-5)
    out, cache = rssm.mamba2_prefill(p, cfg, jnp.asarray(x))
    tout, tcache = ssm.mamba2_prefill(tp, tcfg, torch.from_numpy(x))
    close(out, tout, 1e-5)
    close_trees(cache, tcache, 1e-5)
    for i in range(3):
        xt = draw(rng, 2, 1, cfg.d_model)
        out, cache = rssm.mamba2_decode(p, cfg, jnp.asarray(xt), cache, 8 + i)
        tout, tcache = ssm.mamba2_decode(tp, tcfg, torch.from_numpy(xt),
                                         tcache, 8 + i)
        close(out, tout, 1e-5)
        close_trees(cache, tcache, 1e-5)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


def test_rwkv6_matches_reference():
    """Train, prefill and decode of one RWKV6 time mix with non-zero
    ``u`` and ``mu_*``, and the channel mix, with their carried state."""
    cfg = rcfgs.get_smoke_config("rwkv6_1p6b")
    tcfg = tcfgs.get_smoke_config("rwkv6_1p6b")
    p = to_np(rrwkv.rwkv6_init(jax.random.PRNGKey(5), cfg, jnp.float32)[0])
    rng = np.random.default_rng(6)
    p["u"] = draw(rng, *p["u"].shape)
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        p[name] = rng.random(p[name].shape).astype(np.float32)
    tp = to_torch(p)
    x = draw(rng, 2, 6, cfg.d_model)
    close(rrwkv.rwkv6_train(p, cfg, jnp.asarray(x)),
          rwkv.rwkv6_train(tp, tcfg, torch.from_numpy(x)), 1e-5)
    out, cache = rrwkv.rwkv6_prefill(p, cfg, jnp.asarray(x))
    tout, tcache = rwkv.rwkv6_prefill(tp, tcfg, torch.from_numpy(x))
    close(out, tout, 1e-5)
    close_trees(cache, tcache, 1e-5)
    for i in range(3):
        xt = draw(rng, 2, 1, cfg.d_model)
        out, cache = rrwkv.rwkv6_decode(p, cfg, jnp.asarray(xt), cache, 6 + i)
        tout, tcache = rwkv.rwkv6_decode(tp, tcfg, torch.from_numpy(xt),
                                         tcache, 6 + i)
        close(out, tout, 1e-5)
        close_trees(cache, tcache, 1e-5)
    blk = to_np(rstack._block_init(jax.random.PRNGKey(7), cfg, "rwkv6",
                                   False, jnp.float32)[0])
    blk["mu_ck"] = rng.random(blk["mu_ck"].shape).astype(np.float32)
    x_prev = draw(rng, 2, 1, cfg.d_model)
    close(rstack._channel_mix(blk, cfg, jnp.asarray(x), jnp.asarray(x_prev)),
          channel_mix(to_torch(blk), tcfg, torch.from_numpy(x),
                      torch.from_numpy(x_prev)), 1e-5)


# ---------------------------------------------------------------------------
# the stacks
# ---------------------------------------------------------------------------

B, S, S0 = 2, 12, 8


@pytest.fixture(scope="module", params=ARCHS)
def stack_runs(request):
    """Both packages' forward, prefill, grown caches and 4 decode steps
    over one token draw, the reference's weights in both."""
    arch = request.param
    cfg, tcfg = rcfgs.get_smoke_config(arch), tcfgs.get_smoke_config(arch)
    params, _ = ref_init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_jax(to_np(params), tcfg, "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S))
    runs = {}
    for name, fwd, pre, grow, dec, wrap, m, c in (
            ("ref", ref_forward_train, ref_prefill, ref_grow_caches,
             ref_decode_step, jnp.asarray, params, cfg),
            ("port", forward_train, prefill, serve.grow_caches, decode_step,
             torch.from_numpy, model, tcfg)):
        full, aux, _ = fwd(m, c, {"tokens": wrap(toks)})
        logits, caches = pre(m, c, {"tokens": wrap(toks[:, :S0])})
        grown = grow(caches, S)
        if name == "ref":
            kept = to_np(grown)
        else:
            # decode writes in place: keep copies, and which leaves are
            # prefill's own tensors
            pre = leaves(caches)
            kept = {k: v.clone() if torch.is_tensor(v) else v
                    for k, v in leaves(grown).items()}
            kept_ids = {k: v is pre[k] for k, v in leaves(grown).items()}
        run = {"full": full, "aux": aux, "prefill": logits, "grown": kept,
               "index": caches["index"], "steps": [], "caches": []}
        if name == "port":
            run["grown_is_prefill"] = kept_ids
        caches = grown
        for t in range(S0, S):
            logits, caches = dec(m, c, wrap(toks[:, t:t + 1]), caches, t)
            run["steps"].append(logits)
            # the port writes its caches in place: keep each step's copy
            run["caches"].append(to_np(caches) if name == "ref" else
                                 {k: v.clone() for k, v in
                                  leaves(caches["segments"]).items()})
        runs[name] = run
    return arch, tcfg, model, toks, runs


def test_stack_matches_reference(stack_runs):
    arch, cfg, _, _, runs = stack_runs
    ref, port = runs["ref"], runs["port"]
    close(ref["full"], port["full"], 1e-4)
    assert float(ref["aux"]) == float(port["aux"]) == 0.0
    close(ref["prefill"], port["prefill"], 1e-4)
    assert int(ref["index"]) == port["index"] == S0
    for want, got, wc, gc in zip(ref["steps"], port["steps"], ref["caches"],
                                 port["caches"]):
        close(want, got, 1e-4)
        wc = leaves(wc["segments"])
        assert sorted(wc) == sorted(gc)
        for path, leaf in wc.items():
            close(leaf, gc[path], 1e-5)
    kinds = {k for k, _, _ in cfg.segments()}
    assert kinds == ({"mamba2", "shared_attn"} if arch == "zamba2_2p7b"
                     else {"rwkv6"})


def test_grow_caches_matches_reference(stack_runs):
    """The grown prefill caches ≡ the reference's, leaf for leaf: only
    attention's ``k``/``v`` grow (a shared invocation's on axis 1), every
    Mamba2 ``conv``/``state`` and RWKV6 ``x_prev``/``state`` leaf stays as
    prefill left it."""
    arch, cfg, _, _, runs = stack_runs
    ref, port = runs["ref"], runs["port"]
    grown_ref = {k: v for k, v in leaves(ref["grown"]).items()
                 if k != "/index"}
    grown = {k: v for k, v in port["grown"].items() if k != "/index"}
    assert sorted(grown_ref) == sorted(grown)
    for path, v in grown.items():
        if path.endswith(("/k", "/v")):
            assert v.shape[-3] == S, path
        else:
            assert port["grown_is_prefill"][path], path
    for path in grown_ref:
        close(grown_ref[path], grown[path], 1e-5)


def test_decode_matches_teacher_forcing(stack_runs):
    """The port alone: prefill of 8 tokens and 4 decode steps ≡ its own
    teacher-forcing forward (``test_archs.py``'s bound)."""
    _, _, _, _, runs = stack_runs
    port = runs["port"]
    errs = [float((port["prefill"] - port["full"][:, :S0]).abs().max())]
    errs += [float((step - port["full"][:, S0 + i]).abs().max())
             for i, step in enumerate(port["steps"])]
    assert max(errs) < 5e-4, errs


@pytest.mark.parametrize("arch", ["granite_moe_1b"] + ARCHS)
def test_init_decode_caches_match_reference(arch):
    """Shapes, dtypes and logical axes of the zeroed caches, at the smoke
    config (float32) and at the published one (bfloat16 caches, float32
    states)."""
    for get in ("get_smoke_config", "get_config"):
        cfg, tcfg = getattr(rcfgs, get)(arch), getattr(tcfgs, get)(arch)
        ref_c, ref_ax = ref_init_decode_caches(cfg, 2, 8)
        got_c, got_ax = init_decode_caches(tcfg, 2, 8, device="cpu")
        assert got_ax == ref_ax
        want, got = leaves(ref_c["segments"]), leaves(got_c["segments"])
        assert sorted(want) == sorted(got)
        for path, leaf in want.items():
            assert tuple(got[path].shape) == leaf.shape, path
            assert str(got[path].dtype) == f"torch.{leaf.dtype}", path
            assert not got[path].any()


def test_init_params_mirrors_the_reference_tree():
    """The same tree and logical axes as the reference (the shared block
    without a layer axis, an empty dict for each shared segment), float32
    ``A_log``/``D``/``dt_bias``/``w0``/``u`` in a bfloat16 model, and the
    reference's bfloat16 weights carried into it exactly."""
    for arch in ARCHS:
        cfg = dataclasses.replace(rcfgs.get_smoke_config(arch),
                                  param_dtype="bfloat16")
        tcfg = dataclasses.replace(tcfgs.get_smoke_config(arch),
                                   param_dtype="bfloat16")
        ref_params, ref_axes = ref_init_params(cfg, jax.random.PRNGKey(0))
        _, axes = init_params(tcfg, 0, "cpu")
        assert axes == ref_axes, arch
        model = params_from_jax(to_np(ref_params), tcfg, "cpu")
        got = dict(model.named_parameters())
        f32 = {"A_log", "D", "dt_bias", "w0", "u"}
        for name, v in got.items():
            leaf = name.split(".")[-1]
            want = torch.float32 if leaf in f32 else torch.bfloat16
            assert v.dtype == want, name
        if arch == "zamba2_2p7b":
            assert [s for s in ref_params["segments"] if not s] == [{}] * 4
            w = got["shared_block.mixer.wq.w"]
            assert tuple(w.shape) == (cfg.d_model, cfg.num_heads *
                                      cfg.head_dim)
            np.testing.assert_array_equal(
                w.detach().float().numpy(), np.asarray(
                    ref_params["shared_block"]["mixer"]["wq"]["w"],
                    np.float32))
            np.testing.assert_array_equal(
                got["blocks.0.mixer.A_log"].detach().numpy(),
                np.asarray(ref_params["segments"][0]["mixer"]["A_log"][0]))
    tree = to_np(ref_init_params(rcfgs.get_smoke_config("zamba2_2p7b"),
                                 jax.random.PRNGKey(0))[0])
    tcfg = tcfgs.get_smoke_config("zamba2_2p7b")
    bad = dict(tree, shared_block=dict(tree["shared_block"]))
    del bad["shared_block"]["ln2"]
    with pytest.raises(KeyError, match=r"missing \['shared_block.ln2.scale'"):
        params_from_jax(bad, tcfg, "cpu")
    bad = dict(tree, segments=list(tree["segments"]))
    bad["segments"][1] = {"ln1": {"scale": np.ones((1, 128), np.float32)}}
    with pytest.raises(KeyError, match="unexpected leaf 'segments.1.ln1"):
        params_from_jax(bad, tcfg, "cpu")


def test_launcher_guard_matches_the_host_executor(tmp_path, capsys):
    """``--arch zamba2-2.7b --smoke --service`` on the CPU: the service's
    alerts ≡ the reference's host executor over the same token events."""
    out = serve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                      "--tokens", "24", "--service", "--service-dir",
                      str(tmp_path / "svc")])
    line = capsys.readouterr().out.strip()
    events = out["events"]
    assert len(events) == 24 * 4
    run = out["run"]
    assert run.tokens.shape == run.logp.shape == (4, 24)
    assert np.isfinite(run.logp).all() and (run.logp <= 0).all()
    guard = ref_compile_query(serve.DEFAULT_GUARD).make_executor(
        max_enumerate=1)
    want = sum(len(guard.process(RefEvent("TOK", e))) for e in events)
    assert want > 0
    assert len(out["alerts"]) == want and out["chunks"] == 6
    assert line.startswith(f"generated 24 × 4 lanes; {want} guardrail "
                           f"alerts across 6 chunks")
