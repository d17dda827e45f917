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
                                params_from_jax, prefill)


def run(model, cfg, toks, S0):
    """Teacher forcing, prefill and the decode steps' logits, and the first
    segment's key cache."""
    S = toks.shape[1]
    full = forward_train(model, cfg, {"tokens": toks})[0]
    logits, caches = prefill(model, cfg, {"tokens": toks[:, :S0]})
    caches = serve.grow_caches(caches, S)
    steps = [logits]
    for i in range(S0, S):
        logits_t, caches = decode_step(model, cfg, toks[:, i:i + 1], caches,
                                       i)
        steps.append(logits_t)
    return {"full": full, "steps": steps,
            "k": caches["segments"][0]["mixer"]["k"]}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2p5_14b", "starcoder2_15b"])
def test_smoke_model_on_cuda_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the serve path's default device")
    serve.set_matmul_precision()
    cfg = get_smoke_config(arch)
    cpu, _ = init_params(cfg, 0, "cpu")
    card = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    want = run(cpu, cfg, toks, 8)
    got = run(card, cfg, toks.cuda(), 8)
    for key in ("full", "k"):
        err = float((got[key].cpu() - want[key]).abs().max())
        assert err < 1e-4, (key, err)
    for a, b in zip(got["steps"], want["steps"]):
        assert float((a.cpu() - b).abs().max()) < 1e-4


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
