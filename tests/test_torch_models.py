"""The port's LM serve path (``repro_torch.models``, ``repro_torch.configs``)
against the reference package's on the CPU, in float32.

Inputs are drawn with numpy from a seed; weights are the reference's
``init_params`` tree carried across by ``params_from_jax``.  Tolerances:
layers and GQA 1e-5; the stacks' logits 1e-4 and caches 1e-5; decode ≡
teacher forcing 5e-4, ``test_archs.py``'s.
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
from repro.models import init_params as ref_init_params
from repro.models import layers as rlayers
from repro.models import prefill as ref_prefill
from repro_torch import configs as tcfgs
from repro_torch.models import (attention, decode_step, forward_train,
                                init_decode_caches, init_params, layers,
                                params_from_jax, prefill)

DENSE_ARCHS = ["qwen2p5_14b", "qwen3_32b", "starcoder2_15b",
               "deepseek_coder_33b"]
OTHER_ARCHS = ["zamba2_2p7b", "deepseek_v3_671b", "granite_moe_1b",
               "rwkv6_1p6b", "whisper_base", "internvl2_1b"]


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def close(a, b, atol):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def draw(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def dense_params(rng, din, dout, bias):
    p = {"w": draw(rng, din, dout, scale=din ** -0.5)}
    if bias:
        p["b"] = draw(rng, dout)
    return p


@pytest.mark.parametrize("layer", ["rmsnorm", "rope", "swiglu", "gelu",
                                   "dense_bias"])
def test_layer_matches_reference(layer):
    rng = np.random.default_rng(3)
    x = draw(rng, 2, 5, 4, 32, scale=3.0)
    if layer == "rmsnorm":
        p = {"scale": draw(rng, 32)}
        want = rlayers.rmsnorm(p, jnp.asarray(x), 1e-6)
        got = layers.rmsnorm(to_torch(p), torch.from_numpy(x), 1e-6)
    elif layer == "rope":
        for pos in (np.arange(5)[None, :], np.array([[37], [2]])):
            xs = x[:, :pos.shape[1]]
            want = rlayers.apply_rope(jnp.asarray(xs), jnp.asarray(pos), 1e6)
            got = layers.apply_rope(torch.from_numpy(xs),
                                    torch.from_numpy(pos), 1e6)
            close(want, got, 1e-5)
        return
    elif layer == "dense_bias":
        p = dense_params(rng, 32, 24, bias=True)
        want = rlayers.dense(p, jnp.asarray(x))
        got = layers.dense(to_torch(p), torch.from_numpy(x))
    else:
        kind = layer
        p = {"wi": dense_params(rng, 32, 48, False),
             "wo": dense_params(rng, 48, 32, False)}
        if kind == "swiglu":
            p["wg"] = dense_params(rng, 32, 48, False)
        want = rlayers.mlp(p, jnp.asarray(x), kind)
        got = layers.mlp(to_torch(p), torch.from_numpy(x), kind)
    close(want, got, 1e-5)


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
def test_gqa_prefill_and_decode_match_reference(chunks):
    cfg = dataclasses.replace(rcfgs.get_smoke_config("qwen2p5_14b"),
                              qk_norm=True)
    tcfg = dataclasses.replace(tcfgs.get_smoke_config("qwen2p5_14b"),
                               qk_norm=True)
    p, _ = rattn.gqa_init(jax.random.PRNGKey(4), cfg, jnp.float32)
    p = to_np(p)
    rng = np.random.default_rng(5)
    for name in ("wq", "wk", "wv"):              # non-zero biases
        p[name]["b"] = draw(rng, *p[name]["b"].shape)
    tp = to_torch(p)
    B, S, S_max = 2, 16, 20
    x = draw(rng, B, S, cfg.d_model)
    assert (S % rattn.ATTN_CHUNK_Q == 0) == chunks
    out, cache = rattn.gqa_prefill(p, cfg, jnp.asarray(x))
    tout, tcache = attention.gqa_prefill(tp, tcfg, torch.from_numpy(x))
    close(out, tout, 1e-5)
    close(cache["k"], tcache["k"], 1e-5)
    close(cache["v"], tcache["v"], 1e-5)
    close(rattn.gqa_train(p, cfg, jnp.asarray(x), causal=False),
          attention.gqa_train(tp, tcfg, torch.from_numpy(x), causal=False),
          1e-5)
    pad = ((0, 0), (0, S_max - S), (0, 0), (0, 0))
    cache = {k: jnp.pad(v, pad) for k, v in cache.items()}
    tcache = {k: torch.from_numpy(np.array(np.pad(v.numpy(), pad)))
              for k, v in tcache.items()}
    for index in range(S, S_max):
        xt = draw(rng, B, 1, cfg.d_model)
        out, cache = rattn.gqa_decode(p, cfg, jnp.asarray(xt), cache, index)
        tout, tcache = attention.gqa_decode(tp, tcfg, torch.from_numpy(xt),
                                            tcache, index)
        close(out, tout, 1e-5)
        close(cache["k"], tcache["k"], 1e-5)
        close(cache["v"], tcache["v"], 1e-5)


def both_models(arch):
    cfg, tcfg = rcfgs.get_smoke_config(arch), tcfgs.get_smoke_config(arch)
    params, _ = ref_init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, tcfg, params_from_jax(to_np(params), tcfg, "cpu")


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_stack_matches_reference(arch):
    cfg, params, tcfg, model = both_models(arch)
    B, S, S0 = 2, 12, 8
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S))
    full, aux, mtp = ref_forward_train(params, cfg,
                                       {"tokens": jnp.asarray(toks)})
    tfull, taux, tmtp = forward_train(model, tcfg,
                                      {"tokens": torch.from_numpy(toks)})
    close(full, tfull, 1e-4)
    assert float(taux) == float(aux) == 0.0 and tmtp is mtp is None
    logits, caches = ref_prefill(params, cfg,
                                 {"tokens": jnp.asarray(toks[:, :S0])})
    tlogits, tcaches = prefill(model, tcfg,
                               {"tokens": torch.from_numpy(toks[:, :S0])})
    close(logits, tlogits, 1e-4)
    assert tcaches["index"] == S0
    caches = ref_grow_caches(caches, S)
    grown, _ = init_decode_caches(tcfg, B, S, device="cpu")
    for seg, tseg in zip(tcaches["segments"], grown["segments"]):
        for k in ("k", "v"):
            tseg["mixer"][k][:, :, :S0] = seg["mixer"][k]
    tcaches = grown
    for t in range(S0, S):
        tok = toks[:, t:t + 1]
        logits, caches = ref_decode_step(params, cfg, jnp.asarray(tok),
                                         caches, t)
        tlogits, tcaches = decode_step(model, tcfg, torch.from_numpy(tok),
                                       tcaches, t)
        close(logits, tlogits, 1e-4)
        assert tcaches["index"] == t + 1
        for seg, tseg in zip(caches["segments"], tcaches["segments"]):
            for k in ("k", "v"):
                close(seg["mixer"][k], tseg["mixer"][k], 1e-5)


def test_decode_matches_teacher_forcing():
    """The port alone, for every dense arch: prefill of 8 tokens and 4
    decode steps ≡ the teacher-forcing forward (test_archs.py's bound)."""
    B, S, S0 = 2, 12, 8
    for arch in DENSE_ARCHS:
        cfg = tcfgs.get_smoke_config(arch)
        model, _ = init_params(cfg, 0, "cpu")
        toks = torch.from_numpy(np.random.default_rng(7).integers(
            0, cfg.vocab_size, (B, S)))
        full, _, _ = forward_train(model, cfg, {"tokens": toks})
        logits, caches = prefill(model, cfg, {"tokens": toks[:, :S0]})
        errs = [float((logits - full[:, :S0]).abs().max())]
        grown, _ = init_decode_caches(cfg, B, S, device="cpu")
        for seg, g in zip(caches["segments"], grown["segments"]):
            for k in ("k", "v"):
                g["mixer"][k][:, :, :S0] = seg["mixer"][k]
        caches = grown
        for t in range(S0, S):
            logits_t, caches = decode_step(model, cfg, toks[:, t:t + 1],
                                           caches, t)
            errs.append(float((logits_t - full[:, t]).abs().max()))
        assert max(errs) < 5e-4, (arch, errs)


def test_registry_matches_reference():
    assert tcfgs.ARCHS == rcfgs.ARCHS
    assert tcfgs.ALIASES == rcfgs.ALIASES
    assert tcfgs.SHAPES == rcfgs.SHAPES
    assert tcfgs.all_cells() == rcfgs.all_cells()
    for arch in rcfgs.ARCHS + list(rcfgs.ALIASES):
        for get in ("get_config", "get_smoke_config"):
            ref = getattr(rcfgs, get)(arch)
            port = getattr(tcfgs, get)(arch)
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), arch
            assert port.segments() == ref.segments()
            assert port.layer_kinds() == ref.layer_kinds()
            assert port.padded_vocab == ref.padded_vocab
            assert port.param_counts() == ref.param_counts()
            assert tcfgs.shapes_for(port) == rcfgs.shapes_for(ref)
            assert port.activation_dtype == getattr(torch, ref.dtype)
    padded = dataclasses.replace(tcfgs.get_smoke_config("qwen3_32b"),
                                 vocab_pad_multiple=96)
    assert padded.padded_vocab == 288


def test_other_archs_raise_not_implemented():
    for arch in OTHER_ARCHS:
        cfg = tcfgs.get_smoke_config(arch)
        with pytest.raises(NotImplementedError,
                           match=f"{cfg.name} needs .*ROADMAP Queue 1"):
            init_params(cfg, 0, "cpu")
        with pytest.raises(NotImplementedError, match=cfg.name):
            init_decode_caches(cfg, 2, 8, device="cpu")
    for fn in (attention.mla_init, attention.mla_train,
               attention.mla_prefill, attention.mla_decode,
               attention.gqa_cross, attention.cross_kv):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            fn(None, None, None)


def test_params_from_jax_refuses_a_missing_extra_or_misshapen_leaf():
    cfg, tcfg = (rcfgs.get_smoke_config("starcoder2_15b"),
                 tcfgs.get_smoke_config("starcoder2_15b"))
    tree = to_np(ref_init_params(cfg, jax.random.PRNGKey(0))[0])
    missing = dict(tree)
    del missing["final_norm"]
    with pytest.raises(KeyError, match=r"missing \['final_norm.scale'\]"):
        params_from_jax(missing, tcfg, "cpu")
    extra = dict(tree, segments=[dict(tree["segments"][0],
                                      extra=np.zeros((2, 3), np.float32))])
    with pytest.raises(KeyError, match=r"left over \['blocks.0.extra', "
                                       r"'blocks.1.extra'\]"):
        params_from_jax(extra, tcfg, "cpu")
    wrong = dict(tree, lm_head={"w": tree["lm_head"]["w"][:, :8]})
    with pytest.raises(ValueError, match="lm_head.w has shape"):
        params_from_jax(wrong, tcfg, "cpu")
    unstacked = dict(tree, segments=[{**tree["segments"][0],
                                      "ln1": {"scale": np.ones(
                                          (3, cfg.d_model), np.float32)}}])
    with pytest.raises(ValueError, match="not 2 stacked layers"):
        params_from_jax(unstacked, tcfg, "cpu")


def test_init_params_mirrors_the_reference_tree_and_scheme():
    for arch in DENSE_ARCHS:
        cfg, tcfg = rcfgs.get_smoke_config(arch), tcfgs.get_smoke_config(arch)
        ref_params, ref_axes = ref_init_params(cfg, jax.random.PRNGKey(0))
        model, axes = init_params(tcfg, 0, "cpu")
        assert axes == ref_axes, arch
        # the same leaves and shapes: loading the reference's tree into a
        # model of this config checks both
        params_from_jax(to_np(ref_params), tcfg, "cpu")
    model, _ = init_params(tcfgs.get_smoke_config("qwen2p5_14b"), 0, "cpu")
    again, _ = init_params(tcfgs.get_smoke_config("qwen2p5_14b"), 0, "cpu")
    other, _ = init_params(tcfgs.get_smoke_config("qwen2p5_14b"), 1, "cpu")
    w = dict(model.named_parameters())
    assert all(torch.equal(v, dict(again.named_parameters())[k])
               for k, v in w.items())
    assert not torch.equal(w["lm_head.w"], dict(other.named_parameters())[
        "lm_head.w"])
    for name, v in w.items():
        assert v.dtype == torch.float32, name
        if name.endswith(".scale"):
            assert torch.equal(v, torch.ones_like(v)), name
        elif name.endswith(".b"):
            assert torch.equal(v, torch.zeros_like(v)), name
        else:
            want = 0.02 if name == "embed.embedding" else v.shape[0] ** -0.5
            assert abs(float(v.detach().std()) / want - 1) < 0.1, name
