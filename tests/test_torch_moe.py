"""The port's MoE layer (``repro_torch.models.moe``) and the Granite-MoE
stack against the reference package's on the CPU, in float32.

Inputs are drawn with numpy from a seed; weights are the reference's
(``moe_init`` / ``init_params``), carried across as numpy arrays.
Tolerances: the layer's output 1e-5, its aux loss 1e-6, routing choices
equal; the stack's logits 1e-4, caches 1e-5; decode ≡ teacher forcing
5e-4 (``test_archs.py``'s bound).

Where an expert overflows its capacity the two packages differ on purpose
(ROADMAP Queue 3): the port keeps every token-choice below ``cap``; the
reference scatters the dropped choices onto slot ``cap - 1`` as pads and,
the last write of a repeated index winning on the CPU, loses the token
kept there.  ``test_overflow_keeps_every_slot_below_cap`` holds each
package to its rule, computed here in numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.launch.serve import grow_caches as ref_grow_caches
from repro.models import decode_step as ref_decode_step
from repro.models import forward_train as ref_forward_train
from repro.models import init_params as ref_init_params
from repro.models import moe as rmoe
from repro.models import prefill as ref_prefill
from repro.models.config import MoEConfig as RefMoEConfig
from repro_torch import configs as tcfgs
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward_train, init_params,
                                moe, params_from_jax, prefill)
from repro_torch.models.config import MoEConfig

ARCH = "granite_moe_1b"


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


def configs(mlp="swiglu", shared=0, **moe_kw):
    """The Granite smoke config of both packages with ``moe_kw`` in its
    MoE config."""
    kw = dict(num_experts=4, top_k=2, d_ff=64, capacity_factor=4.0,
              num_shared_experts=shared, shared_d_ff=32 if shared else 0)
    kw.update(moe_kw)
    ref = dataclasses.replace(rcfgs.get_smoke_config(ARCH), mlp=mlp,
                              moe=RefMoEConfig(**kw))
    port = dataclasses.replace(tcfgs.get_smoke_config(ARCH), mlp=mlp,
                               moe=MoEConfig(**kw))
    return ref, port


def layer(cfg, seed=1):
    p, _ = rmoe.moe_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return to_np(p)


def ref_choices(p, cfg, x):
    """The reference's top-k over its softmax (``_moe_global``'s)."""
    xf = jnp.asarray(x).reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(xf @ p["router"]["w"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])


# ---------------------------------------------------------------------------
# a numpy oracle of both slot rules
# ---------------------------------------------------------------------------


def oracle(p, cfg, x, *, reference_fault: bool):
    """y (B, S, d) and the expert counts from the routing alone: each
    expert takes its token-choices in token order up to ``cap``; with
    ``reference_fault`` an expert that overflows also loses the choice in
    its slot ``cap - 1``."""
    m = cfg.moe
    B, S, d = x.shape
    xf = x.reshape(-1, d).astype(np.float64)
    T, E, k = xf.shape[0], m.num_experts, m.top_k
    cap = max(1, int(m.capacity_factor * T * k / E))
    logits = xf @ p["router"]["w"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    choices = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    gates = np.take_along_axis(probs, choices, -1)
    gates /= gates.sum(-1, keepdims=True)

    def ffn(w, v):
        """The MLP of weights ``w`` (wi, wo, and wg for swiglu) on v."""
        a = v @ w["wi"].astype(np.float64)
        if cfg.mlp == "swiglu":
            g = v @ w["wg"].astype(np.float64)
            h = g / (1 + np.exp(-g)) * a
        else:
            h = 0.5 * a * (1 + np.tanh(np.sqrt(2 / np.pi)
                                       * (a + 0.044715 * a ** 3)))
        return h @ w["wo"].astype(np.float64)

    y = np.zeros_like(xf)
    counts = np.bincount(choices.reshape(-1), minlength=E)
    for e in range(E):
        # token-choices of expert e in the order of the flat (T*k) index
        rows = [(t, i) for t in range(T) for i in range(k)
                if choices[t, i] == e]
        for pos, (t, i) in enumerate(rows[:cap]):
            if reference_fault and counts[e] > cap and pos == cap - 1:
                continue
            expert = {n: p[n][e] for n in ("wi", "wg", "wo") if n in p}
            y[t] += gates[t, i] * ffn(expert, xf[t])
    if m.num_shared_experts:
        y += ffn({n: w["w"] for n, w in p["shared"].items()}, xf)
    return y.reshape(B, S, d), counts, cap


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["swiglu", "gelu_shared", "top1"])
def test_moe_apply_matches_reference(case):
    kw = {"swiglu": {}, "gelu_shared": dict(mlp="gelu", shared=1),
          "top1": dict(top_k=1, num_experts=8, capacity_factor=8.0)}[case]
    cfg, tcfg = configs(**kw)
    p = layer(cfg)
    x = np.random.default_rng(2).standard_normal(
        (3, 5, cfg.d_model)).astype(np.float32)
    y, aux = rmoe._moe_global(p, cfg, jnp.asarray(x))
    ty, taux = moe.moe_apply(to_torch(p), tcfg, torch.from_numpy(x))
    close(y, ty, 1e-5)
    assert abs(float(taux) - float(aux)) < 1e-6, (float(aux), float(taux))
    _, _, choices = moe.route(to_torch(p), tcfg,
                              torch.from_numpy(x).reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(choices.numpy(), ref_choices(p, cfg, x))
    # no expert overflows here, so both slot rules give the same output
    want, counts, cap = oracle(p, cfg, x, reference_fault=False)
    assert counts.max() <= cap
    close(want, ty, 1e-5)


def test_topk_orders_ties_by_expert_id():
    """Equal probabilities take the lower expert id first, as
    ``jax.lax.top_k`` does: a zero router (every probability 1/E) and a
    router whose columns repeat in pairs."""
    cfg, tcfg = configs(num_experts=8, top_k=3)
    x = np.random.default_rng(3).standard_normal(
        (6, cfg.d_model)).astype(np.float32)
    zero = {"router": {"w": np.zeros((cfg.d_model, 8), np.float32)}}
    w = np.random.default_rng(4).standard_normal(
        (cfg.d_model, 4)).astype(np.float32)
    pairs = {"router": {"w": np.repeat(w, 2, axis=1)}}
    for p in (zero, pairs):
        _, gates, choices = moe.route(to_torch(p), tcfg, torch.from_numpy(x))
        want = ref_choices(p, cfg, x)
        np.testing.assert_array_equal(choices.numpy(), want)
        assert (np.diff(gates.numpy(), axis=-1) <= 0).all()
    np.testing.assert_array_equal(want[:, 0] % 2, 0)   # the even of a pair
    _, _, choices = moe.route(to_torch(zero), tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(choices.numpy(), [[0, 1, 2]] * 6)


@pytest.mark.parametrize("case", ["E4_k2_T8_cf1", "decode_E32_k8_T4"])
def test_overflow_keeps_every_slot_below_cap(case):
    """ROADMAP Queue 3: where an expert overflows, the port follows the
    capacity rule (every choice below ``cap`` keeps its slot) and the
    reference loses the choice in slot ``cap - 1`` to a pad.  The second
    case is Granite's decode step at its published capacity factor 1.25:
    4 lanes × top-8 of 32 experts gives ``cap`` 1."""
    if case == "E4_k2_T8_cf1":
        cfg, tcfg = configs(num_experts=4, top_k=2, capacity_factor=1.0)
        shape = (2, 4, cfg.d_model)
    else:
        cfg, tcfg = configs(num_experts=32, top_k=8, capacity_factor=1.25)
        shape = (4, 1, cfg.d_model)
    p = layer(cfg, seed=5)
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    capacity_rule, counts, cap = oracle(p, cfg, x, reference_fault=False)
    fault, _, _ = oracle(p, cfg, x, reference_fault=True)
    assert cap == moe.capacity(tcfg, shape[0] * shape[1])
    assert counts.max() > cap, counts              # an expert overflows
    y, aux = rmoe._moe_global(p, cfg, jnp.asarray(x))
    ty, taux = moe.moe_apply(to_torch(p), tcfg, torch.from_numpy(x))
    close(capacity_rule, ty, 1e-5)
    close(fault, y, 1e-5)
    assert float(np.abs(np.asarray(y) - ty.numpy()).max()) > 1e-2
    assert abs(float(taux) - float(aux)) < 1e-6


# ---------------------------------------------------------------------------
# the Granite stack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def granite():
    cfg, tcfg = rcfgs.get_smoke_config(ARCH), tcfgs.get_smoke_config(ARCH)
    params, _ = ref_init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, tcfg, params_from_jax(to_np(params), tcfg, "cpu")


def test_granite_stack_matches_reference(granite):
    cfg, params, tcfg, model = granite
    B, S, S0 = 2, 12, 8
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S))
    full, aux, _ = ref_forward_train(params, cfg,
                                     {"tokens": jnp.asarray(toks)})
    tfull, taux, tmtp = forward_train(model, tcfg,
                                      {"tokens": torch.from_numpy(toks)})
    close(full, tfull, 1e-4)
    assert float(aux) > 0 and abs(float(taux) - float(aux)) < 1e-6
    assert tmtp is None
    logits, caches = ref_prefill(params, cfg,
                                 {"tokens": jnp.asarray(toks[:, :S0])})
    tlogits, tcaches = prefill(model, tcfg,
                               {"tokens": torch.from_numpy(toks[:, :S0])})
    close(logits, tlogits, 1e-4)
    assert tcaches["index"] == int(caches["index"]) == S0
    caches = ref_grow_caches(caches, S)
    tcaches = serve.grow_caches(tcaches, S)
    for t in range(S0, S):
        tok = toks[:, t:t + 1]
        logits, caches = ref_decode_step(params, cfg, jnp.asarray(tok),
                                         caches, t)
        tlogits, tcaches = decode_step(model, tcfg, torch.from_numpy(tok),
                                       tcaches, t)
        close(logits, tlogits, 1e-4)
        assert tcaches["index"] == int(caches["index"]) == t + 1
        want = jax.tree_util.tree_leaves_with_path(caches["segments"])
        got = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda v: v.numpy(), tcaches["segments"]))
        assert [p for p, _ in want] == [p for p, _ in got]
        for (_, w), (_, g) in zip(want, got):
            close(w, g, 1e-5)


def test_granite_decode_matches_teacher_forcing(granite):
    """The port alone: prefill of 8 tokens and 4 decode steps ≡ the
    teacher-forcing forward (``test_archs.py``'s bound)."""
    _, _, cfg, model = granite
    B, S, S0 = 2, 12, 8
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)))
    full = forward_train(model, cfg, {"tokens": toks})[0]
    logits, caches = prefill(model, cfg, {"tokens": toks[:, :S0]})
    errs = [float((logits - full[:, :S0]).abs().max())]
    caches = serve.grow_caches(caches, S)
    for t in range(S0, S):
        logits_t, caches = decode_step(model, cfg, toks[:, t:t + 1], caches,
                                       t)
        errs.append(float((logits_t - full[:, t]).abs().max()))
    assert max(errs) < 5e-4, errs


def test_init_params_mirrors_the_reference_tree_and_scheme():
    cfg, tcfg = rcfgs.get_smoke_config(ARCH), tcfgs.get_smoke_config(ARCH)
    ref_params, ref_axes = ref_init_params(cfg, jax.random.PRNGKey(0))
    model, axes = init_params(tcfg, 0, "cpu")
    assert axes == ref_axes
    params_from_jax(to_np(ref_params), tcfg, "cpu")   # same leaves, shapes
    w = dict(model.named_parameters())
    m = tcfg.moe
    assert w["blocks.0.moe.wi"].shape == (m.num_experts, tcfg.d_model,
                                          m.d_ff)
    for name, v in w.items():
        if name.endswith((".wi", ".wg")):
            want = tcfg.d_model ** -0.5
        elif name.endswith(".wo"):
            want = m.d_ff ** -0.5
        elif name.endswith(".w"):
            want = v.shape[0] ** -0.5
        else:
            continue
        assert abs(float(v.detach().std()) / want - 1) < 0.1, name
    # the published config in bfloat16: every leaf bf16, one draw a seed
    pub = dataclasses.replace(tcfgs.get_config(ARCH), num_layers=1,
                              vocab_size=256)
    a, _ = init_params(pub, 0, "cpu")
    b, _ = init_params(dataclasses.replace(pub, moe=dataclasses.replace(
        pub.moe, capacity_factor=4.0)), 0, "cpu")
    for (name, v), u in zip(a.named_parameters(), b.parameters()):
        assert v.dtype == torch.bfloat16, name
        assert torch.equal(v, u), name    # the capacity factor draws nothing
