"""The port's encoder-decoder (Whisper: the bidirectional encoder,
``cross_kv`` and ``gqa_cross``) and vision-prefix (InternVL: the projected
patches before the tokens) serve paths against the reference package's on
the CPU, in float32.

Inputs are drawn with numpy from a seed, the frames and patches among them
(random, not the reference launcher's ones, which would hide a fault of a
position in the encoder or the prefix); weights are the reference's,
carried across by ``params_from_jax``.  Tolerance 1e-5 on logits and every
cache leaf, ``cross_kv`` included; decode ≡ teacher forcing 5e-4
(``test_archs.py``'s bound).  The reference's stack runs are shared
through module-scoped fixtures.
"""
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
from repro.models import prefill as ref_prefill
from repro.models import stack as rstack
from repro_torch import configs as tcfgs
from repro_torch.launch import serve
from repro_torch.models import (attention, decode_step, forward_train,
                                init_decode_caches, init_params,
                                params_from_jax, prefill)

ARCHS = ["whisper_base", "internvl2_1b"]
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


def batch_np(cfg, seed=6):
    """Tokens (B, S) and the arch's frames or patches, from a seed."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.encoder_layers:
        batch["frames"] = draw(rng, B, cfg.encoder_seq, cfg.d_model)
    if cfg.frontend == "vision_stub":
        batch["patches"] = draw(rng, B, cfg.frontend_seq, cfg.frontend_dim)
    return batch


def prefix_of(cfg):
    return cfg.frontend_seq if cfg.frontend == "vision_stub" else 0


@pytest.fixture
def chunks(request):
    """Both packages' attention chunk sizes, restored afterwards."""
    old_ref = (rattn.ATTN_CHUNK_Q, rattn.ATTN_CHUNK_K)
    old_port = (attention.ATTN_CHUNK_Q, attention.ATTN_CHUNK_K)
    rattn.set_chunk_sizes(4, 8)
    attention.set_chunk_sizes(4, 8)
    yield
    rattn.set_chunk_sizes(*old_ref)
    attention.set_chunk_sizes(*old_port)


@pytest.mark.parametrize("S_enc", [30, 32], ids=["one_kv_chunk",
                                                 "four_kv_chunks"])
def test_gqa_cross_and_cross_kv_match_reference(chunks, S_enc):
    """``cross_kv`` (no RoPE) and ``gqa_cross`` (no mask) ≡ the
    reference's, with query chunks of 4 and KV chunks of 8: 30 encoder
    positions take one KV chunk (8 does not divide them), 32 take four;
    one decode query takes one query chunk."""
    cfg = rcfgs.get_smoke_config("whisper_base")
    tcfg = tcfgs.get_smoke_config("whisper_base")
    p = to_np(rattn.gqa_init(jax.random.PRNGKey(4), cfg, jnp.float32)[0])
    tp = to_torch(p)
    rng = np.random.default_rng(S_enc)
    enc = draw(rng, B, S_enc, cfg.d_model)
    kv = rattn.cross_kv(p, cfg, jnp.asarray(enc))
    tkv = attention.cross_kv(tp, tcfg, torch.from_numpy(enc))
    close_trees(kv, tkv, 1e-5)
    for S_q in (8, 1):
        x = draw(rng, B, S_q, cfg.d_model)
        close(rattn.gqa_cross(p, cfg, jnp.asarray(x), kv),
              attention.gqa_cross(tp, tcfg, torch.from_numpy(x), tkv), 1e-5)


def test_encoder_matches_reference():
    """Whisper's encoder over random frames: blocks without cross, run
    bidirectionally, then ``final_norm``; frames not projected."""
    cfg = rcfgs.get_smoke_config("whisper_base")
    tcfg = tcfgs.get_smoke_config("whisper_base")
    params, _ = ref_init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_jax(to_np(params), tcfg, "cpu")
    frames = batch_np(cfg)["frames"]
    want = rstack._run_encoder(params, cfg, jnp.asarray(frames))
    with torch.no_grad():
        got = model.encoder(torch.from_numpy(frames))
    close(want, got, 1e-5)
    assert all("cross" not in blk for blk in model.encoder.blocks)
    assert all("cross" in blk for blk in model.blocks)


@pytest.fixture(scope="module", params=ARCHS)
def stack_runs(request):
    """Both packages' teacher forcing, prefill (caches kept before they
    grow) and four decode steps from the prefix's end, over the same
    weights, tokens and frames or patches."""
    arch = request.param
    cfg, tcfg = rcfgs.get_smoke_config(arch), tcfgs.get_smoke_config(arch)
    params, _ = ref_init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_jax(to_np(params), tcfg, "cpu")
    batch = batch_np(cfg)
    toks = batch["tokens"]
    pre = prefix_of(cfg)
    runs = {}
    for name, fwd, pref, grow, dec, wrap, m, c in (
            ("ref", ref_forward_train, ref_prefill, ref_grow_caches,
             ref_decode_step, jnp.asarray, params, cfg),
            ("port", forward_train, prefill, serve.grow_caches, decode_step,
             torch.from_numpy, model, tcfg)):
        full, aux, mtp = fwd(m, c, {k: wrap(v) for k, v in batch.items()})
        b0 = {k: wrap(v[:, :S0] if k == "tokens" else v)
              for k, v in batch.items()}
        logits, caches = pref(m, c, b0)
        kept = to_np(caches) if name == "ref" else {
            k: v.clone() if torch.is_tensor(v) else v
            for k, v in leaves(caches).items()}
        grown = grow(caches, pre + S)
        run = {"full": full, "aux": aux, "mtp": mtp, "prefill": logits,
               "prefill_caches": kept, "index": caches["index"],
               "grown": to_np(grown) if name == "ref" else {
                   k: v.clone() if torch.is_tensor(v) else v
                   for k, v in leaves(grown).items()},
               "steps": [], "caches": []}
        caches = grown
        for t in range(S0, S):
            logits, caches = dec(m, c, wrap(toks[:, t:t + 1]), caches,
                                 pre + t)
            run["steps"].append(logits)
            run["caches"].append(to_np(caches) if name == "ref" else
                                 {k: v.clone() for k, v in
                                  leaves(caches["segments"]).items()})
        runs[name] = run
    return arch, tcfg, model, runs


def test_forward_train_matches_reference(stack_runs):
    arch, cfg, _, runs = stack_runs
    ref, port = runs["ref"], runs["port"]
    close(ref["full"], port["full"], 1e-5)
    assert port["full"].shape[1] == prefix_of(cfg) + S
    assert float(ref["aux"]) == float(port["aux"]) == 0.0
    assert ref["mtp"] is None and port["mtp"] is None


def test_prefill_and_its_caches_match_reference(stack_runs):
    """Prefill's logits over the prefix and every cache leaf: the
    self-attention ``k``/``v`` over prefix + prompt, Whisper's
    ``cross_kv`` over the encoder's positions."""
    arch, cfg, _, runs = stack_runs
    ref, port = runs["ref"], runs["port"]
    close(ref["prefill"], port["prefill"], 1e-5)
    assert ref["index"] == port["index"] == prefix_of(cfg) + S0
    want = {k: v for k, v in leaves(ref["prefill_caches"]).items()
            if k != "/index"}
    got = {k: v for k, v in port["prefill_caches"].items() if k != "/index"}
    assert sorted(want) == sorted(got)
    for path, leaf in want.items():
        assert str(leaf.dtype) == str(got[path].dtype)[6:], path
        close(leaf, got[path], 1e-5)
    cross = [p for p in got if "/cross_kv/" in p]
    if arch == "whisper_base":
        assert sorted(cross) == ["/segments/0/cross_kv/k",
                                 "/segments/0/cross_kv/v"]
        assert got[cross[0]].shape == (cfg.num_layers, B, cfg.encoder_seq,
                                       cfg.num_kv_heads, cfg.head_dim)
    else:
        assert not cross


def test_decode_matches_reference_and_teacher_forcing(stack_runs):
    """Each decode step at ``prefix + t`` ≡ the reference's
    ``decode_step``: logits and every cache leaf after the step; and the
    port alone, prefill and the four steps ≡ its own teacher forcing at
    the same positions (``test_archs.py``'s bound)."""
    _, cfg, _, runs = stack_runs
    ref, port = runs["ref"], runs["port"]
    for want, got, wc, gc in zip(ref["steps"], port["steps"], ref["caches"],
                                 port["caches"]):
        close(want, got, 1e-5)
        wc = leaves(wc["segments"])
        assert sorted(wc) == sorted(gc)
        for path, leaf in wc.items():
            close(leaf, gc[path], 1e-5)
    pre = prefix_of(cfg)
    errs = [float((port["prefill"] - port["full"][:, :pre + S0])
                  .abs().max())]
    errs += [float((step - port["full"][:, pre + S0 + i]).abs().max())
             for i, step in enumerate(port["steps"])]
    assert max(errs) < 5e-4, errs


def test_grow_caches_with_a_prefix(stack_runs):
    """The grown caches ≡ the reference's: ``k``/``v`` padded to prefix +
    S on their sequence axis, ``cross_kv`` passed through unpadded."""
    arch, cfg, _, runs = stack_runs
    ref, port = runs["ref"], runs["port"]
    grown_ref = {k: v for k, v in leaves(ref["grown"]).items()
                 if k != "/index"}
    grown = {k: v for k, v in port["grown"].items() if k != "/index"}
    assert sorted(grown_ref) == sorted(grown)
    for path, v in grown.items():
        if "/cross_kv/" in path:
            assert v.shape[2] == cfg.encoder_seq, path
        else:
            assert v.shape[2] == prefix_of(cfg) + S, path
        close(grown_ref[path], v, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_caches_match_reference(arch):
    """Trees, shapes, dtypes and logical axes of the zeroed caches, at the
    smoke config (float32) and the published one (bfloat16); the port's
    ``cross_kv`` ``k`` and ``v`` are two tensors, the reference's one
    array twice."""
    for get in ("get_smoke_config", "get_config"):
        cfg, tcfg = getattr(rcfgs, get)(arch), getattr(tcfgs, get)(arch)
        ref_c, ref_ax = ref_init_decode_caches(cfg, 2, 8)
        got_c, got_ax = init_decode_caches(tcfg, 2, 8, device="cpu")
        assert got_ax == ref_ax
        assert got_c["index"] == int(ref_c["index"]) == 0
        want, got = leaves(ref_c["segments"]), leaves(got_c["segments"])
        assert sorted(want) == sorted(got)
        for path, leaf in want.items():
            assert tuple(got[path].shape) == leaf.shape, path
            assert str(got[path].dtype) == f"torch.{leaf.dtype}", path
            assert not got[path].any()
        if cfg.cross_attention:
            seg = got_c["segments"][0]["cross_kv"]
            assert seg["k"].data_ptr() != seg["v"].data_ptr()
            assert seg["k"].shape[2] == cfg.encoder_seq


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_generate_matches_reference(arch):
    """``serve.generate`` with the frontend's input (``make_frontend``)
    ≡ the reference launcher's loop (prefill, ``grow_caches`` to prompt +
    prefix + tokens, greedy ``decode_step`` at ``S0 + t + prefix``): the
    same tokens and log-probabilities; and ``serve.main`` runs the arch's
    smoke config."""
    cfg, tcfg = rcfgs.get_smoke_config(arch), tcfgs.get_smoke_config(arch)
    params, _ = ref_init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_jax(to_np(params), tcfg, "cpu")
    prompt = serve.make_prompt(tcfg, B, S0, "cpu")
    frontend = serve.make_frontend(tcfg, B, "cpu")
    assert sorted(frontend) == (["frames"] if cfg.encoder_layers
                                else ["patches"])
    n = 6
    run = serve.generate(model, tcfg, prompt, n, frontend=frontend)
    pre = prefix_of(cfg)
    assert run.prefix == pre and run.prefill_logits.shape[1] == pre + S0
    batch = {k: jnp.asarray(v.numpy()) for k, v in frontend.items()}
    batch["tokens"] = jnp.asarray(prompt.numpy())
    logits, caches = ref_prefill(params, cfg, batch)
    caches = ref_grow_caches(caches, S0 + n + pre)
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None]
    toks, logps = [], []
    for t in range(n):
        logits_t, caches = ref_decode_step(params, cfg, tok, caches,
                                           S0 + t + pre)
        logp = jax.nn.log_softmax(logits_t, axis=-1)
        tok = jnp.argmax(logits_t, axis=-1)[:, None]
        toks.append(np.asarray(tok[:, 0]))
        logps.append(np.take_along_axis(np.asarray(logp), np.asarray(tok),
                                        axis=1)[:, 0])
    np.testing.assert_array_equal(run.tokens, np.stack(toks, axis=1))
    close(np.stack(logps, axis=1), run.logp, 1e-5)
    out = serve.main(["--arch", tcfg.name, "--smoke", "--device", "cpu",
                      "--tokens", "4"])
    assert len(out["events"]) == 4 * 4 and out["run"].prefix == pre


def test_params_from_jax_carries_the_encoder_and_frontend():
    """The stacked encoder leaves, ``encoder.final_norm`` and
    ``frontend_proj`` carry over exactly; a missing, extra or misshapen
    one raises."""
    cfg = rcfgs.get_smoke_config("whisper_base")
    tcfg = tcfgs.get_smoke_config("whisper_base")
    tree = to_np(ref_init_params(cfg, jax.random.PRNGKey(0))[0])
    model = params_from_jax(tree, tcfg, "cpu")
    got = dict(model.named_parameters())
    for i in range(cfg.encoder_layers):
        np.testing.assert_array_equal(
            got[f"encoder.blocks.{i}.mixer.wq.w"].detach().numpy(),
            tree["encoder"]["blocks"]["mixer"]["wq"]["w"][i])
    enc = dict(tree["encoder"])
    del enc["final_norm"]
    with pytest.raises(KeyError, match=r"missing \['encoder.final_norm"):
        params_from_jax(dict(tree, encoder=enc), tcfg, "cpu")
    enc = dict(tree["encoder"], blocks=dict(
        tree["encoder"]["blocks"], extra=np.zeros((2, 3), np.float32)))
    with pytest.raises(KeyError, match=r"left over \['encoder.blocks.0.extra'"):
        params_from_jax(dict(tree, encoder=enc), tcfg, "cpu")
    enc = dict(tree["encoder"], blocks=dict(
        tree["encoder"]["blocks"], ln1={"scale": np.ones(
            (3, cfg.d_model), np.float32)}))
    with pytest.raises(ValueError, match="not 2 stacked layers"):
        params_from_jax(dict(tree, encoder=enc), tcfg, "cpu")

    cfg = rcfgs.get_smoke_config("internvl2_1b")
    tcfg = tcfgs.get_smoke_config("internvl2_1b")
    tree = to_np(ref_init_params(cfg, jax.random.PRNGKey(0))[0])
    model = params_from_jax(tree, tcfg, "cpu")
    np.testing.assert_array_equal(
        model.frontend_proj["w"].detach().numpy(), tree["frontend_proj"]["w"])
    wrong = dict(tree, frontend_proj={"w": tree["frontend_proj"]["w"][:4]})
    with pytest.raises(ValueError, match="frontend_proj.w has shape"):
        params_from_jax(wrong, tcfg, "cpu")
    missing = dict(tree)
    del missing["frontend_proj"]
    with pytest.raises(KeyError, match=r"missing \['frontend_proj.w'\]"):
        params_from_jax(missing, tcfg, "cpu")
