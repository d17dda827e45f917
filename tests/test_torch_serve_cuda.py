"""The LM serve path on the card against the CPU, and its refusal to run
without one.

``test_smoke_model_on_cuda_matches_cpu`` needs a CUDA device and skips
without one (decided inside the test); it imports no JAX.  The refusal
test runs everywhere: it hides the card, if any, and then checks that no
entry point falls back to the CPU.
"""
import copy

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward_train, init_params,
                                moe, params_from_jax, prefill)

NEAR_TIE = 1e-5     # a routing margin below which the card may choose apart


def leaves(tree, prefix=""):
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


class Routes:
    """Every MoE layer's routing during a run, in call order: the chosen
    experts of each token and the margin between its k-th and (k+1)-th
    probabilities."""

    def __init__(self, model):
        self.calls = []
        self.handles = [m.register_forward_hook(self.hook)
                        for m in model.modules() if isinstance(m, moe.MoE)]

    def hook(self, module, inputs, output):
        x = inputs[0]
        probs, _, choices = moe.route(module, module.cfg,
                                      x.reshape(-1, x.shape[-1]))
        k = module.cfg.moe.top_k
        top = probs.sort(dim=-1, descending=True).values
        margin = top[:, k - 1] - top[:, k] if k < top.shape[1] else \
            torch.full_like(top[:, 0], float("inf"))
        self.calls.append((x.shape[:2], choices.cpu(), margin.cpu()))

    def remove(self):
        for h in self.handles:
            h.remove()


def run(model, cfg, toks, S0, frontend):
    """Teacher forcing (with the MTP logits, where the arch has them),
    prefill and the decode steps' logits, every cache leaf after the last
    step, and the MoE layers' routing; ``frontend`` the frames or patches
    given with the tokens."""
    routes = Routes(model)
    S = toks.shape[1]
    with torch.no_grad():
        full, _, mtp = forward_train(model, cfg, dict(frontend, tokens=toks))
    logits, caches = prefill(model, cfg, dict(frontend, tokens=toks[:, :S0]))
    start = caches["index"]
    caches = serve.grow_caches(caches, start + S - S0)
    steps = [logits]
    for i in range(S0, S):
        logits_t, caches = decode_step(model, cfg, toks[:, i:i + 1], caches,
                                       start + i - S0)
        steps.append(logits_t)
    routes.remove()
    return {"full": full, "mtp": mtp, "steps": steps,
            "caches": leaves(caches["segments"]), "routes": routes.calls}


def lanes_apart(got, want):
    """Lanes whose routing differs between the runs; each difference must
    be a near-tie on the CPU (margin below ``NEAR_TIE``)."""
    apart = set()
    assert len(got) == len(want)
    for (shape, c_got, _), (_, c_want, margin) in zip(got, want):
        rows = (c_got != c_want).any(dim=-1).nonzero()[:, 0]
        assert bool((margin[rows] < NEAR_TIE).all()), margin[rows]
        apart.update(int(r) // shape[1] for r in rows)
    return apart


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2p5_14b", "starcoder2_15b",
                                  "granite_moe_1b", "zamba2_2p7b",
                                  "rwkv6_1p6b", "whisper_base",
                                  "internvl2_1b", "deepseek_v3_671b"])
def test_smoke_model_on_cuda_matches_cpu(arch):
    """The smoke model on the card ≡ on the CPU at 1e-4: logits of teacher
    forcing (and MTP), prefill and each decode step, and every cache leaf
    (Whisper's ``cross_kv`` and MLA's latent among them), over the same
    frames or patches; MoE routing compared first, and lanes routed apart
    at a near-tie (counted) left out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the serve path's default device")
    serve.set_matmul_precision()
    cfg = get_smoke_config(arch)
    cpu, _ = init_params(cfg, 0, "cpu")
    card = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    frontend = serve.make_frontend(cfg, 2, "cpu")
    want = run(cpu, cfg, toks, 8, frontend)
    got = run(card, cfg, toks.cuda(), 8,
              {k: v.cuda() for k, v in frontend.items()})
    apart = lanes_apart(got["routes"], want["routes"])
    keep = [b for b in range(toks.shape[0]) if b not in apart]
    assert keep, f"every lane routed apart at a near-tie: {sorted(apart)}"
    err = float((got["full"][keep].cpu() - want["full"][keep]).abs().max())
    assert err < 1e-4, ("full", err)
    assert (got["mtp"] is None) == (want["mtp"] is None) == (
        not cfg.mtp_depth)
    if cfg.mtp_depth:
        err = float((got["mtp"][keep].cpu() - want["mtp"][keep]).abs().max())
        assert err < 1e-4, ("mtp", err)
    for a, b in zip(got["steps"], want["steps"]):
        assert float((a[keep].cpu() - b[keep]).abs().max()) < 1e-4
    assert sorted(got["caches"]) == sorted(want["caches"])
    shared = {f"/{i}/" for i, (kind, _, _) in enumerate(cfg.segments())
              if kind == "shared_attn"}
    for path, leaf in want["caches"].items():
        # lanes on axis 1 under a segment's layer axis; a shared-attention
        # invocation's cache has none
        lane_axis = 0 if path.startswith(tuple(shared)) else 1
        g = got["caches"][path].cpu().index_select(lane_axis,
                                                   torch.tensor(keep))
        w = leaf.index_select(lane_axis, torch.tensor(keep))
        assert g.dtype == w.dtype, path
        assert float((g.float() - w.float()).abs().max()) < 1e-4, path


def test_entry_points_need_cuda_without_a_device(monkeypatch):
    cfg = get_smoke_config("qwen2p5_14b")
    if torch.cuda.is_available():
        model, _ = init_params(cfg, 0)
        assert next(model.parameters()).device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, 0)
    cpu, _ = init_params(cfg, 0, "cpu")
    tree = {"embed": {"embedding": cpu.embed["embedding"].detach().numpy()}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2.5-14b", "--smoke"])
