"""The port's serve launcher (``repro_torch.launch.serve``) and its
monitored-serving example (``examples/torch_serve_monitored.py``) on the
CPU, against the reference package's launcher, example and host executor.

The guard's counts are exact; the decode's log-probabilities, with the
reference's weights carried across by ``params_from_jax``, agree within
1e-5, and none lies within 1e-4 of the guard's threshold of -2.5, so the
comparison of the guard's matches cannot hinge on rounding.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.core import Event as RefEvent
from repro.core import compile_query as ref_compile_query
from repro.launch.serve import grow_caches as ref_grow_caches
from repro.models import init_decode_caches as ref_init_decode_caches
from repro.models import init_params as ref_init_params
from repro.models import make_prefill_step as ref_make_prefill_step
from repro.models import make_serve_step as ref_make_serve_step
from repro_torch import configs as tcfgs
from repro_torch.launch import serve
from repro_torch.models import (decode_step, init_decode_caches,
                                make_prefill_step, make_serve_step,
                                params_from_jax, prefill)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
THRESHOLD = -2.5


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_fired(query: str, events) -> int:
    """Matches of the reference's host executor over ``events``."""
    guard = ref_compile_query(query).make_executor(max_enumerate=1)
    return sum(len(guard.process(RefEvent("TOK", e))) for e in events)


def test_grow_caches_and_decode_caches_match_reference():
    cfg, tcfg = (rcfgs.get_smoke_config("qwen3_32b"),
                 tcfgs.get_smoke_config("qwen3_32b"))
    rng = np.random.default_rng(11)
    shape = (cfg.num_layers, 2, 5, cfg.num_kv_heads, cfg.head_dim)
    kv = {k: rng.standard_normal(shape).astype(np.float32) for k in "kv"}
    ref = ref_grow_caches({"index": 5, "segments": [
        {"mixer": {k: jnp.asarray(v) for k, v in kv.items()}}]}, 9)
    got = serve.grow_caches({"index": 5, "segments": [
        {"mixer": {k: torch.from_numpy(v) for k, v in kv.items()}}]}, 9)
    assert got["index"] == 5
    for k in "kv":
        np.testing.assert_array_equal(
            got["segments"][0]["mixer"][k].numpy(),
            np.asarray(ref["segments"][0]["mixer"][k]))
    ref_c, ref_ax = ref_init_decode_caches(cfg, 3, 16)
    got_c, got_ax = init_decode_caches(tcfg, 3, 16, device="cpu")
    assert got_ax == ref_ax
    for seg, tseg in zip(ref_c["segments"], got_c["segments"]):
        for k in "kv":
            assert tuple(tseg["mixer"][k].shape) == seg["mixer"][k].shape
            assert not tseg["mixer"][k].any()
            assert tseg["mixer"][k].dtype == torch.float32


def test_serve_and_prefill_steps_match_reference():
    cfg, tcfg = (rcfgs.get_smoke_config("qwen2p5_14b"),
                 tcfgs.get_smoke_config("qwen2p5_14b"))
    params, _ = ref_init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (3, 7))
    logits, caches = ref_make_prefill_step(cfg)(
        params, {"tokens": jnp.asarray(toks)})
    tlogits, tcaches = make_prefill_step(tcfg)(
        model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits),
                               rtol=0, atol=1e-4)
    caches, tcaches = ref_grow_caches(caches, 9), serve.grow_caches(tcaches, 9)
    serve_step = jax.jit(ref_make_serve_step(cfg))
    tserve_step = make_serve_step(tcfg)
    for t in (7, 8):
        tok = toks[:, t - 7:t - 6]
        logits, caches = serve_step(params, jnp.asarray(tok), caches, t)
        tlogits, tcaches = tserve_step(model, torch.from_numpy(tok),
                                       tcaches, t)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits),
                                   rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="built for"):
        prefill(model, tcfgs.get_smoke_config("qwen3_32b"),
                {"tokens": torch.from_numpy(toks)})
    with pytest.raises(ValueError, match="built for"):
        decode_step(model, tcfgs.get_smoke_config("qwen3_32b"),
                    torch.from_numpy(toks[:, :1]), tcaches, 9)


@pytest.mark.parametrize("mode", ["host", "service"])
def test_launcher_guard_matches_the_host_executor(mode, tmp_path, capsys):
    argv = ["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu",
            "--tokens", "24"]
    if mode == "service":
        argv += ["--service", "--service-dir", str(tmp_path / "svc")]
    out = serve.main(argv)
    line = capsys.readouterr().out.strip()
    events = out["events"]
    assert len(events) == 24 * 4
    assert [e["lane"] for e in events] == list(range(4)) * 24
    run = out["run"]
    assert run.tokens.shape == run.logp.shape == (4, 24)
    assert np.isfinite(run.logp).all() and (run.logp <= 0).all()
    assert tuple(run.fed.shape) == (4, 8 + 24)
    want = ref_fired(serve.DEFAULT_GUARD, events)
    assert want > 0
    if mode == "host":
        assert out["fired"] == want
        assert line == f"generated 24 × 4 lanes; guardrail fired {want}×"
    else:
        assert len(out["alerts"]) == want
        assert out["chunks"] == 6          # 96 events in chunks of 16
        assert line.startswith(f"generated 24 × 4 lanes; {want} guardrail "
                               f"alerts across 6 chunks (compile_count=0")
        assert (tmp_path / "svc").is_dir()


@pytest.fixture(scope="module")
def example_runs():
    """Both examples' token events with the reference's weights and
    prompt: the reference's ``decode_token_events`` and the port's."""
    ref, port = load("serve_monitored"), load("torch_serve_monitored")
    tokens, lanes = 16, 4
    cfg = ref.tiny_serving_config()
    params, _ = ref_init_params(cfg, jax.random.PRNGKey(0))
    prompt = jax.random.randint(jax.random.PRNGKey(1), (lanes, 8), 0,
                                cfg.vocab_size)
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            port.tiny_serving_config(), "cpu")
    got = port.decode_token_events(tokens, lanes, "cpu", model=model,
                                   prompt=torch.from_numpy(
                                       np.array(prompt)).long())
    want = ref.decode_token_events(tokens, lanes)
    # the free-running tokens compare exactly only where no near-tie in the
    # argmax could turn on rounding: every step's top-2 margin exceeds the
    # logits' tolerance of 1e-4
    run = serve.generate(model, port.tiny_serving_config(),
                         torch.from_numpy(np.array(prompt)).long(), tokens,
                         keep_logits=True)
    steps = [run.prefill_logits[:, -1]] + run.step_logits
    top2 = torch.stack(steps).topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4
    return ref, port, want, got


def test_example_decode_matches_the_reference_example(example_runs):
    ref, port, want, got = example_runs
    assert port.GUARD == ref.GUARD and port.BURST_GUARD == ref.BURST_GUARD
    assert dataclasses.asdict(port.tiny_serving_config()) == \
        dataclasses.asdict(ref.tiny_serving_config())
    assert len(got) == len(want) == 16 * 4
    for w, g in zip(want, got):
        assert {k: g[k] for k in ("type", "lane", "t", "tok")} == \
            {k: w[k] for k in ("type", "lane", "t", "tok")}
        assert abs(g["logp"] - w["logp"]) < 1e-5, (w, g)
    logp = np.array([w["logp"] for w in want])
    assert np.abs(logp - THRESHOLD).min() > 1e-4


def test_example_host_guard_matches_the_reference_example(example_runs,
                                                          capsys):
    ref, port, want, got = example_runs
    fired = port.run_host_guard(got)
    assert fired == ref.run_host_guard(want)
    assert len(fired) == ref_fired(port.GUARD, [
        {k: r[k] for k in ("lane", "logp", "tok")} for r in got]) > 0
    port.main(["--device", "cpu", "--tokens", "12"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "generated 12 tokens × 4 lanes"
    assert lines[1].startswith("guardrail fired ")


def test_example_service_leg_exits_0():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / "torch_serve_monitored.py"),
         "--service", "--device", "cpu"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "generated 48 tokens × 4 lanes"
    assert lines[1].startswith("service ≡ host baseline: ")
    assert "3 malformed events dead-lettered, compile_count=0" in lines[1]
    assert lines[2].startswith("overflow self-heal: ring 8 → ")
