"""The port's MLA (``repro_torch.models.attention``: ``mla_train``,
``mla_prefill``, ``mla_decode`` in its absorbed and expanded forms), MTP
and shared experts, and the DeepSeek-V3 smoke stack, against the
reference package's on the CPU, in float32.

Inputs are drawn with numpy from a seed; weights are the reference's,
carried across as numpy arrays or by ``params_from_jax``.  Tolerance 1e-5
on outputs, logits, ``mtp_logits``, aux and every cache leaf; decode ≡
teacher forcing 5e-4 (``test_archs.py``'s bound).  The smoke config's
capacity (factor 4, 8 experts, top 2) holds every token-choice, so the
port's and the reference's dispatch agree (ROADMAP Queue 3 item 6 is the
case where they do not).  The reference's stack runs are shared through a
module-scoped fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.launch.serve import grow_caches as ref_grow_caches
from repro.models import attention as rattn
from repro.models import decode_step as ref_decode_step
from repro.models import forward_train as ref_forward_train
from repro.models import init_decode_caches as ref_init_decode_caches
from repro.models import init_params as ref_init_params
from repro.models import moe as rmoe
from repro.models import prefill as ref_prefill
from repro_torch import configs as tcfgs
from repro_torch.launch import serve
from repro_torch.models import (MLA, attention, decode_step, forward_train,
                                init_decode_caches, init_params, moe,
                                params_from_jax, prefill)

ARCH = "deepseek_v3_671b"
B, S, S0 = 2, 12, 8


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


def draw(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def configs():
    return rcfgs.get_smoke_config(ARCH), tcfgs.get_smoke_config(ARCH)


@pytest.fixture
def chunks(request):
    """Both packages' attention chunk sizes, restored afterwards."""
    old_ref = (rattn.ATTN_CHUNK_Q, rattn.ATTN_CHUNK_K)
    old_port = (attention.ATTN_CHUNK_Q, attention.ATTN_CHUNK_K)
    q, k = request.param
    if q:
        rattn.set_chunk_sizes(q, k)
        attention.set_chunk_sizes(q, k)
    yield bool(q)
    rattn.set_chunk_sizes(*old_ref)
    attention.set_chunk_sizes(*old_port)


@pytest.mark.parametrize("chunks", [(0, 0), (4, 8)], indirect=True,
                         ids=["unchunked", "chunked"])
def test_mla_matches_reference(chunks):
    """``mla_train`` and ``mla_prefill`` (``c_kv`` after ``kvnorm``,
    ``k_rope`` after RoPE), then four decode steps of each form, absorbed
    and expanded, ≡ the reference's same form: outputs and both cache
    leaves; the two forms agree with each other."""
    cfg, tcfg = configs()
    p = to_np(rattn.mla_init(jax.random.PRNGKey(4), cfg, jnp.float32)[0])
    tp = to_torch(p)
    rng = np.random.default_rng(5)
    S_pre, S_max = 16, 20
    x = draw(rng, B, S_pre, cfg.d_model)
    close(rattn.mla_train(p, cfg, jnp.asarray(x)),
          attention.mla_train(tp, tcfg, torch.from_numpy(x)), 1e-5)
    out, cache = rattn.mla_prefill(p, cfg, jnp.asarray(x))
    tout, tcache = attention.mla_prefill(tp, tcfg, torch.from_numpy(x))
    close(out, tout, 1e-5)
    assert sorted(tcache) == ["c_kv", "k_rope"]
    for k in tcache:
        close(cache[k], tcache[k], 1e-5)
    assert tcache["c_kv"].shape == (B, S_pre, cfg.kv_lora_rank)
    assert tcache["k_rope"].shape == (B, S_pre, cfg.rope_head_dim)
    pad = ((0, 0), (0, S_max - S_pre), (0, 0))
    xs = [draw(rng, B, 1, cfg.d_model) for _ in range(S_pre, S_max)]
    outs = {}
    for absorbed in (True, False):
        c = {k: jnp.pad(v, pad) for k, v in cache.items()}
        tc = {k: torch.from_numpy(np.pad(v.numpy(), pad))
              for k, v in tcache.items()}
        outs[absorbed] = []
        for index, xt in zip(range(S_pre, S_max), xs):
            o, c = rattn.mla_decode(p, cfg, jnp.asarray(xt), c, index,
                                    absorbed=absorbed)
            to, tc = attention.mla_decode(tp, tcfg, torch.from_numpy(xt),
                                          tc, index, absorbed=absorbed)
            close(o, to, 1e-5)
            for k in tc:
                close(c[k], tc[k], 1e-5)
            outs[absorbed].append(to)
    for a, b in zip(outs[True], outs[False]):
        close(a.numpy(), b, 1e-5)


def test_moe_with_the_shared_expert_matches_moe_global():
    """DeepSeek-V3's MoE layer at the smoke config (8 experts, top 2, one
    shared expert) ≡ the reference's ``_moe_global``: output and aux."""
    cfg, tcfg = configs()
    p = to_np(rmoe.moe_init(jax.random.PRNGKey(7), cfg, jnp.float32)[0])
    assert "shared" in p
    x = draw(np.random.default_rng(8), B, S, cfg.d_model)
    y, aux = rmoe._moe_global(p, cfg, jnp.asarray(x))
    ty, taux = moe.moe_apply(to_torch(p), tcfg, torch.from_numpy(x))
    close(y, ty, 1e-5)
    close(aux, taux, 1e-6)
    no_shared = {k: v for k, v in p.items() if k != "shared"}
    ns_cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, num_shared_experts=0))
    y_ns, _ = moe.moe_apply(to_torch(no_shared), ns_cfg,
                            torch.from_numpy(x))
    shared = moe.mlp(to_torch(p["shared"]), torch.from_numpy(x), cfg.mlp)
    close((y_ns + shared).numpy(), ty, 1e-5)


def ref_decode_expanded(monkeypatch):
    """The reference's stack decoding through the expanded form."""
    plain = rattn.mla_decode

    def expanded(*args, **kwargs):
        return plain(*args, **dict(kwargs, absorbed=False))
    monkeypatch.setattr(rattn, "mla_decode", expanded)


@pytest.fixture(scope="module")
def stack_runs():
    """Both packages' teacher forcing (with MTP) and prefill (caches kept),
    once; then four decode steps in each MLA form, each from a copy of
    the same grown caches, over the same weights and tokens."""
    cfg, tcfg = configs()
    params, _ = ref_init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_jax(to_np(params), tcfg, "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S))
    packages = (("ref", ref_forward_train, ref_prefill, ref_grow_caches,
                 ref_decode_step, jnp.asarray, params, cfg),
                ("port", forward_train, prefill, serve.grow_caches,
                 decode_step, torch.from_numpy, model, tcfg))
    runs, grown = {}, {}
    for name, fwd, pref, grow, _, wrap, m, c in packages:
        full, aux, mtp = fwd(m, c, {"tokens": wrap(toks)})
        logits, caches = pref(m, c, {"tokens": wrap(toks[:, :S0])})
        kept = to_np(caches) if name == "ref" else {
            k: v.clone() if torch.is_tensor(v) else v
            for k, v in leaves(caches).items()}
        grown[name] = grow(caches, S)
        run = {"full": full, "aux": aux, "mtp": mtp, "prefill": logits,
               "prefill_caches": kept, "index": caches["index"],
               "grown": to_np(grown[name]) if name == "ref" else
               leaves(grown[name])}
        for absorbed in (True, False):
            runs[name, absorbed] = dict(run, steps=[], caches=[])
    mp = pytest.MonkeyPatch()
    try:
        for absorbed in (True, False):
            if not absorbed:
                ref_decode_expanded(mp)
                for m in model.modules():
                    if isinstance(m, MLA):
                        m.absorbed = False
            for name, _, _, _, dec, wrap, m, c in packages:
                run = runs[name, absorbed]
                # the port decodes in place: each form from its own copy
                caches = grown[name] if name == "ref" else jax.tree.map(
                    lambda v: v.clone() if torch.is_tensor(v) else v,
                    grown[name])
                for t in range(S0, S):
                    logits, caches = dec(m, c, wrap(toks[:, t:t + 1]),
                                         caches, t)
                    run["steps"].append(logits)
                    run["caches"].append(to_np(caches) if name == "ref" else
                                         {k: v.clone() for k, v in
                                          leaves(caches["segments"]).items()})
    finally:
        mp.undo()
        for m in model.modules():
            if isinstance(m, MLA):
                m.absorbed = True
    return tcfg, model, runs


def test_forward_train_with_mtp_matches_reference(stack_runs):
    """Logits, the MoE layers' summed aux and ``mtp_logits`` (from the
    hidden state before the final norm, the next token's embedding
    rolled with wrap-around, the MTP block and norm, the final norm
    again)."""
    cfg, _, runs = stack_runs
    ref, port = runs["ref", True], runs["port", True]
    close(ref["full"], port["full"], 1e-5)
    close(ref["aux"], port["aux"], 1e-6)
    assert float(port["aux"]) > 0.0
    assert port["mtp"] is not None
    close(ref["mtp"], port["mtp"], 1e-5)
    assert port["mtp"].shape == port["full"].shape
    assert cfg.segments() == [("attn", False, 1), ("attn", True, 3)]


def test_prefill_and_its_caches_match_reference(stack_runs):
    """Prefill's logits and every cache leaf: ``c_kv`` (layers, B, S0,
    kv_lora_rank) and ``k_rope`` (layers, B, S0, rope_head_dim) per
    segment."""
    cfg, _, runs = stack_runs
    ref, port = runs["ref", True], runs["port", True]
    close(ref["prefill"], port["prefill"], 1e-5)
    assert int(ref["index"]) == port["index"] == S0
    want = {k: v for k, v in leaves(ref["prefill_caches"]).items()
            if k != "/index"}
    got = {k: v for k, v in port["prefill_caches"].items() if k != "/index"}
    assert sorted(want) == sorted(got) == [
        f"/segments/{s}/mixer/{k}" for s in (0, 1) for k in ("c_kv",
                                                             "k_rope")]
    for path, leaf in want.items():
        close(leaf, got[path], 1e-5)
    assert got["/segments/1/mixer/c_kv"].shape == (3, B, S0,
                                                   cfg.kv_lora_rank)


@pytest.mark.parametrize("absorbed", [True, False],
                         ids=["absorbed", "expanded"])
def test_decode_matches_reference(stack_runs, absorbed):
    """Each decode step ≡ the reference's ``decode_step`` in the same MLA
    form: logits and every cache leaf after the step; the port's two forms
    ≡ each other; and the port alone ≡ its own teacher forcing
    (``test_archs.py``'s bound)."""
    _, _, runs = stack_runs
    ref, port = runs["ref", absorbed], runs["port", absorbed]
    for want, got, wc, gc in zip(ref["steps"], port["steps"], ref["caches"],
                                 port["caches"]):
        close(want, got, 1e-5)
        wc = leaves(wc["segments"])
        assert sorted(wc) == sorted(gc)
        for path, leaf in wc.items():
            close(leaf, gc[path], 1e-5)
    for a, b in zip(port["steps"], runs["port", not absorbed]["steps"]):
        close(a.numpy(), b, 1e-5)
    errs = [float((port["prefill"] - port["full"][:, :S0]).abs().max())]
    errs += [float((step - port["full"][:, S0 + i]).abs().max())
             for i, step in enumerate(port["steps"])]
    assert max(errs) < 5e-4, errs


def test_grow_caches_pads_the_latent(stack_runs):
    """``grow_caches`` pads ``c_kv`` and ``k_rope`` on their sequence axis
    (``ndim - 2``) to S, as the reference's does."""
    _, _, runs = stack_runs
    ref, port = runs["ref", True], runs["port", True]
    grown_ref = {k: v for k, v in leaves(ref["grown"]).items()
                 if k != "/index"}
    grown = {k: v for k, v in port["grown"].items() if k != "/index"}
    assert sorted(grown_ref) == sorted(grown)
    for path, v in grown.items():
        assert v.shape[2] == S, path
        assert not v[:, :, S0:].any(), path
        close(grown_ref[path], v, 1e-5)


def test_init_decode_caches_match_reference():
    """Trees, shapes, dtypes and logical axes of the zeroed latent caches,
    at the smoke config (float32) and the published one (bfloat16, 61
    layers in two segments)."""
    for get in ("get_smoke_config", "get_config"):
        cfg, tcfg = getattr(rcfgs, get)(ARCH), getattr(tcfgs, get)(ARCH)
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
    """The same tree and logical axes as the reference (MLA mixers, the
    shared expert, ``mtp``); its bfloat16 weights carried in exactly; a
    missing, extra or misshapen ``mtp`` leaf raises."""
    cfg, tcfg = configs()
    ref_params, ref_axes = ref_init_params(cfg, jax.random.PRNGKey(0))
    model, axes = init_params(tcfg, 0, "cpu")
    assert axes == ref_axes
    tree = to_np(ref_params)
    model = params_from_jax(tree, tcfg, "cpu")
    got = dict(model.named_parameters())
    np.testing.assert_array_equal(got["mtp.proj.w"].detach().numpy(),
                                  tree["mtp"]["proj"]["w"])
    np.testing.assert_array_equal(
        got["mtp.block.mixer.wkv_b.w"].detach().numpy(),
        tree["mtp"]["block"]["mixer"]["wkv_b"]["w"])
    np.testing.assert_array_equal(
        got["blocks.2.moe.shared.wg.w"].detach().numpy(),
        tree["segments"][1]["moe"]["shared"]["wg"]["w"][1])
    assert isinstance(model.mtp["block"]["mixer"], MLA)
    mtp = dict(tree["mtp"])
    del mtp["norm"]
    with pytest.raises(KeyError, match=r"missing \['mtp.norm.scale'\]"):
        params_from_jax(dict(tree, mtp=mtp), tcfg, "cpu")
    mtp = dict(tree["mtp"], extra={"w": np.zeros((2, 3), np.float32)})
    with pytest.raises(KeyError, match=r"left over \['mtp.extra.w'\]"):
        params_from_jax(dict(tree, mtp=mtp), tcfg, "cpu")
    mtp = dict(tree["mtp"], proj={"w": tree["mtp"]["proj"]["w"][:8]})
    with pytest.raises(ValueError, match="mtp.proj.w has shape"):
        params_from_jax(dict(tree, mtp=mtp), tcfg, "cpu")


def test_launcher_generate_matches_reference():
    """``serve.generate`` ≡ the reference launcher's greedy loop: the same
    tokens and log-probabilities."""
    cfg, tcfg = configs()
    params, _ = ref_init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_jax(to_np(params), tcfg, "cpu")
    prompt = serve.make_prompt(tcfg, B, S0, "cpu")
    assert serve.make_frontend(tcfg, B, "cpu") == {}
    n = 6
    run = serve.generate(model, tcfg, prompt, n)
    logits, caches = ref_prefill(params, cfg,
                                 {"tokens": jnp.asarray(prompt.numpy())})
    caches = ref_grow_caches(caches, S0 + n)
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None]
    toks, logps = [], []
    for t in range(n):
        logits_t, caches = ref_decode_step(params, cfg, tok, caches, S0 + t)
        logp = jax.nn.log_softmax(logits_t, axis=-1)
        tok = jnp.argmax(logits_t, axis=-1)[:, None]
        toks.append(np.asarray(tok[:, 0]))
        logps.append(np.take_along_axis(np.asarray(logp), np.asarray(tok),
                                        axis=1)[:, 0])
    np.testing.assert_array_equal(run.tokens, np.stack(toks, axis=1))
    close(np.stack(logps, axis=1), run.logp, 1e-5)
