"""Training on the card against the CPU, and the training entry points'
refusal to run without one.

``test_smoke_train_step_on_cuda_matches_cpu`` needs a CUDA device and
skips without one (decided inside the test); it imports no JAX.  The
refusal tests run everywhere: they hide the card, if any, and check that
no training entry point falls back to the CPU.
"""
import copy

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import host_model_mesh, use_model_mesh
from repro_torch.models import (init_train_state, make_train_step,
                                state_tree)
from repro_torch.models.convert import tree_to_numpy
from repro_torch.optim import AdamWConfig, adamw_init


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def two_steps(model, cfg, batches, compress):
    # eps 1e-6: see tests/test_torch_train.py (the step's direction at an
    # |g| near eps would amplify rounding)
    opt = AdamWConfig(warmup_steps=1, total_steps=100, eps=1e-6)
    params = dict(model.named_parameters())
    state = {"params": model, "opt": adamw_init(params, opt)}
    if compress:
        state["err"] = {n: torch.zeros_like(p) for n, p in params.items()}
    step = make_train_step(cfg, opt, compress=compress)
    metrics = []
    with use_model_mesh(host_model_mesh()):
        for b in batches:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, tree_to_numpy(state_tree(state, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,compress", [("qwen2p5_14b", False),
                                           ("granite_moe_1b", True),
                                           ("deepseek_v3_671b", False)])
def test_smoke_train_step_on_cuda_matches_cpu(arch, compress):
    """Two train steps of the smoke model (float32, the launcher's mesh of
    one rank) on the card ≡ on the CPU: every metric within 1e-5 relative,
    parameters and moments within 1e-4 of their leaf's largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the train path's default device")
    serve.set_matmul_precision()
    cfg = get_smoke_config(arch)
    cpu_state, _ = init_train_state(cfg, AdamWConfig(), 0, device="cpu")
    cpu = cpu_state["params"]
    card = copy.deepcopy(cpu).to("cuda")
    data = TokenPipeline(cfg.vocab_size, 2, 32, seed=4, device="cpu")
    batches = [data.batch_at(i) for i in range(2)]
    want_m, want = two_steps(cpu, cfg, batches, compress)
    got_m, got = two_steps(card, cfg, [{k: v.cuda() for k, v in b.items()}
                                       for b in batches], compress)
    for a, b in zip(got_m, want_m):
        assert sorted(a) == sorted(b)
        for k in b:
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), (k, a, b)
    fa, fb = flat(got), flat(want)
    assert sorted(fa) == sorted(fb)
    for k in fb:
        scale = max(1.0, float(abs(fb[k]).max())) if fb[k].size else 1.0
        assert float(abs(fa[k] - fb[k]).max()) <= 1e-4 * scale, k


def test_train_entry_points_need_cuda_without_a_device(monkeypatch, tmp_path):
    cfg = get_smoke_config("qwen2p5_14b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, AdamWConfig(), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenPipeline(cfg.vocab_size, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen2.5-14b", "--smoke", "--steps", "1",
                    "--checkpoint-dir", str(tmp_path)])


def test_train_launcher_refuses_multi_pod(tmp_path, monkeypatch):
    """``--multi-pod`` takes the 2×16×16 mesh of 512 ranks (the mesh of
    one rank at a world of one); at a world of 4 it is refused before
    anything is built, naming the meshes the launcher takes."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="2×16×16"):
        train.main(["--arch", "qwen2.5-14b", "--multi-pod",
                    "--device", "cpu", "--checkpoint-dir", str(tmp_path)])


def test_train_launcher_smoke_on_the_cpu(tmp_path, capsys):
    """``--device cpu --smoke``: Granite's smoke config, 2 steps of 8 ×
    64 tokens (512: the stationary pass) with compressed gradients; the
    report and a checkpoint at step 2."""
    out = train.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                      "--steps", "2", "--compress-grads", "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path)])
    assert capsys.readouterr().out.startswith("done: {'final_step': 2")
    assert out["report"]["final_step"] == 2
    assert all(m["loss"] == m["loss"] for m in out["metrics"])
    assert (tmp_path / "step_2" / "manifest.json").exists()
