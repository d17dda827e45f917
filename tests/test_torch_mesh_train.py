"""The port's production-mesh paths against the reference's on the CPU:
the pipeline over ``pod``, two train steps with the state placed as
DTensors by ``TRAIN_RULES``, greedy decode with the weights placed by
``DECODE_RULES``, and both launchers on the production mesh.

The port runs on gloo ranks spawned from ``tests/_mesh_ranks.py``; the
reference on forced host devices in a subprocess
(``tests/_mesh_reference.py``), both from the reference's initial weights
at smoke configs (float32): Qwen2.5-14B's unless said otherwise.

* ``pipeline_forward`` on 2 ranks: rank ``r``'s output buffer ≡ the
  reference's on device ``r`` (the last stage's holds the stack's output
  ≡ the port's plain forward; stage 0's stays zero, which is what the
  reference's global output reads: ROADMAP Queue 3);
* two train steps on data 2 × model 2, on pod 2 × data 1 × model 2
  (each pod a replica, the gradients averaged over pods), and of
  Granite-MoE-1B on data 2 × model 2 (the experts over model): loss within
  1e-5, ``grad_norm`` within 1e-4 of itself, every parameter within 0.01
  of a step's learning rate (``PERF.md`` §2), moments within 1e-4 of
  their scale;
* greedy decode on data 1 × model 2, of Qwen2.5-14B, Zamba2-2.7B
  (Mamba2 and its shared attention block) and DeepSeek-V3 (MLA, the
  caches split over their sequence, and MoE): the same tokens;
* the launchers without ``--smoke`` at a world of one take the
  production mesh (``--multi-pod`` included) and match their ``--smoke``
  path's numbers on the same config; any other world is refused.
"""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import _mesh_ranks as mr
from repro import configs as rcfgs
from repro.models import init_params as ref_init_params
from repro_torch import configs as tcfgs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.pipeline import pipeline_forward
from repro_torch.models import params_from_jax

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, the reference's runs and the port ranks' outputs."""
    work = str(tmp_path_factory.mktemp("mesh_train"))
    flat = {}
    archs = {a for a, _ in mr.TRAIN_CASES} | set(mr.SERVE_ARCHS)
    for arch in sorted(archs):
        params, _ = ref_init_params(rcfgs.get_smoke_config(arch),
                                    jax.random.PRNGKey(0))
        for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
            path = "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                            for e in k)
            flat[f"{mr.params_key(arch)}/{path}"] = np.asarray(v)
    rng = np.random.default_rng(3)
    for i, (arch, _) in enumerate(mr.TRAIN_CASES):
        vocab = rcfgs.get_smoke_config(arch).vocab_size
        for t in range(mr.TRAIN_STEPS):
            flat[f"tokens/{i}/{t}"] = rng.integers(
                0, vocab, (mr.TRAIN_B, mr.TRAIN_S)).astype(np.int32)
    for j, arch in enumerate(mr.SERVE_ARCHS):
        flat[f"serve/{j}/prompt"] = rng.integers(
            0, rcfgs.get_smoke_config(arch).vocab_size,
            (mr.SERVE_B, mr.SERVE_PROMPT)).astype(np.int64)
    cfg = rcfgs.get_smoke_config(mr.ARCH)
    flat["pipe/x"] = rng.normal(size=(mr.PIPE_MICRO, mr.PIPE_B, mr.PIPE_S,
                                      cfg.d_model)).astype(np.float32)
    np.savez(os.path.join(work, "inputs.npz"), **flat)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    ref = subprocess.Popen([sys.executable,
                            str(ROOT / "tests" / "_mesh_reference.py"),
                            work, "train", "serve", "pipeline"], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        train = mr.spawn(mr.train_rank_main, 4, work, "train")
        serve = mr.spawn(mr.serve_rank_main, 2, work, "serve")
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-4000:]
    refs = {k: dict(np.load(os.path.join(work, f"ref_{k}.npz")))
            for k in ("train", "serve", "pipeline")}
    return {"inputs": flat, "ref": refs, "train": train, "serve": serve}


def test_pipeline_buffers_match_reference_devices(runs):
    ref = runs["ref"]["pipeline"]
    for r, out in enumerate(runs["serve"]):
        np.testing.assert_allclose(out["pipe/out"], ref[f"pipe/{r}"],
                                   rtol=0, atol=1e-5)
    assert np.abs(runs["serve"][1]["pipe/out"]).max() > 1.0
    assert not np.any(runs["serve"][0]["pipe/out"])


def test_pipeline_last_stage_is_the_whole_stack(runs):
    cfg = tcfgs.get_smoke_config(mr.ARCH)
    model = params_from_jax(mr.unflatten(runs["inputs"], "params"), cfg,
                            "cpu")
    x = torch.from_numpy(runs["inputs"]["pipe/x"])
    with torch.no_grad():
        plain = pipeline_forward(list(model.blocks), cfg, x,
                                 n_micro=mr.PIPE_MICRO,
                                 mesh=tmesh.host_model_mesh())
        want = []
        for m in range(mr.PIPE_MICRO):
            h = x[m]
            for blk in model.blocks:
                h, _ = blk(h)
            want.append(h)
    np.testing.assert_array_equal(plain.numpy(), torch.stack(want).numpy())
    np.testing.assert_allclose(runs["serve"][1]["pipe/out"], plain.numpy(),
                               rtol=0, atol=1e-5)


def test_reference_pipeline_global_output_reads_stage_zero(runs):
    """The reference's fault (Queue 3): its global output is stage 0's
    buffer, zero, while the last stage's holds the result."""
    ref = runs["ref"]["pipeline"]
    assert not np.any(ref["pipe/global"])
    assert np.abs(ref["pipe/1"]).max() > 1.0


def test_pipeline_refuses_other_pod_sizes_and_blocks():
    cfg = tcfgs.get_smoke_config(mr.ARCH)
    x = torch.zeros(2, 1, 4, cfg.d_model)
    four = SimpleNamespace(axis_names=("pod", "data"),
                           axis_size=lambda a: {"pod": 4, "data": 1}[a])
    with pytest.raises(ValueError, match="2 stages"):
        pipeline_forward([], cfg, x, n_micro=2, mesh=four)
    moe = tcfgs.get_smoke_config("granite-moe-1b-a400m")
    from repro_torch.models import init_params
    model, _ = init_params(moe, 0, "cpu")
    with pytest.raises(ValueError, match="dense attention"):
        pipeline_forward(list(model.blocks), moe, x, n_micro=2,
                         mesh=tmesh.host_model_mesh())


@pytest.mark.parametrize("mesh", range(len(mr.TRAIN_CASES)),
                         ids=["data2_model2", "pod2_data1_model2",
                              "moe_data2_model2"])
def test_two_train_steps_match_reference(runs, mesh):
    ref, port = runs["ref"]["train"], runs["train"]
    i = f"{mesh}/"
    lr = ref[i + "metrics/0/lr"]
    for out in port:
        assert bool(out[i + "all_dtensor"])
        for t in range(mr.TRAIN_STEPS):
            m = f"{i}metrics/{t}/"
            assert abs(out[m + "loss"] - ref[m + "loss"]) <= 1e-5
            assert abs(out[m + "ce"] - ref[m + "ce"]) <= 1e-5
            assert abs(out[m + "grad_norm"] - ref[m + "grad_norm"]) <= \
                1e-4 * ref[m + "grad_norm"]
            assert out[m + "lr"] == pytest.approx(ref[m + "lr"], rel=1e-6)
    # the batch split over pod and data: 4 rows over 2 ranks a replica
    assert all(int(o[i + "batch_rows"]) == 2 for o in port)
    out = port[0]
    keys = [k for k in ref if k.startswith(i + "params/")]
    assert len(keys) > 10
    for k in keys:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=0.01 * lr,
                                   err_msg=k)
    # each rank holds its blocks of the state: under half of it on 2 × 2
    # (norm scales and biases that the model axis does not split stay
    # whole), and over pods the replica's half
    whole = sum(ref[k].nbytes for k in ref
                if k.startswith((i + "params/", i + "mu/", i + "nu/")))
    assert max(o[i + "state_bytes"] for o in port) < (
        0.75 if "pod" in mr.TRAIN_CASES[mesh][1] else 0.5) * whole


@pytest.mark.parametrize("mesh", range(len(mr.TRAIN_CASES)),
                         ids=["data2_model2", "pod2_data1_model2",
                              "moe_data2_model2"])
def test_moments_after_two_steps_match_reference(runs, mesh):
    ref, out = runs["ref"]["train"], runs["train"][0]
    i = f"{mesh}/"
    for k in [k for k in ref if k.startswith((i + "mu/", i + "nu/"))]:
        scale = max(float(np.abs(ref[k]).max()), 1e-12)
        np.testing.assert_allclose(out[k], ref[k], rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("arch", range(len(mr.SERVE_ARCHS)),
                         ids=mr.SERVE_ARCHS)
def test_serve_tokens_match_reference(runs, arch):
    want = runs["ref"]["serve"][f"serve/{arch}/tokens"]
    assert want.shape == (mr.SERVE_B, mr.SERVE_TOKENS)
    for out in runs["serve"]:
        np.testing.assert_array_equal(out[f"serve/{arch}/tokens"], want)


# ---------------------------------------------------------------------------
# the launchers at a world of one
# ---------------------------------------------------------------------------


@pytest.fixture
def smoke_as_published(monkeypatch):
    """The launchers' published config replaced by the smoke config, so
    the production path runs at a size the CPU takes."""
    monkeypatch.setattr(ttrain, "get_config", tcfgs.get_smoke_config)
    monkeypatch.setattr(tserve, "get_config", tcfgs.get_smoke_config)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_launcher_takes_the_production_mesh(smoke_as_published,
                                                  tmp_path, multi_pod):
    common = ["--arch", "granite-moe-1b-a400m", "--steps", "2",
              "--global-batch", "2", "--seq-len", "16", "--device", "cpu",
              "--checkpoint-every", "100"]
    smoke = ttrain.main(common + ["--smoke", "--checkpoint-dir",
                                  str(tmp_path / "a")])
    prod = ttrain.main(common + ["--checkpoint-dir", str(tmp_path / "b")]
                       + (["--multi-pod"] if multi_pod else []))
    assert prod["mesh"] == ({"pod": 1, "data": 1, "model": 1} if multi_pod
                            else {"data": 1, "model": 1})
    assert not torch.distributed.is_initialized()
    for a, b in zip(smoke["metrics"], prod["metrics"]):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    # rank 0 wrote the final checkpoint of full tensors
    assert sorted(os.listdir(tmp_path / "b")) == sorted(
        os.listdir(tmp_path / "a"))


def test_serve_launcher_takes_the_production_mesh(smoke_as_published):
    common = ["--arch", "qwen2.5-14b", "--tokens", "4", "--lanes", "2",
              "--device", "cpu"]
    smoke = tserve.main(common + ["--smoke"])
    prod = tserve.main(common)
    assert prod["mesh"] == {"data": 1, "model": 1}
    np.testing.assert_array_equal(prod["run"].tokens, smoke["run"].tokens)
    assert prod["events"] == smoke["events"]


def test_production_shape_takes_the_reference_meshes_only():
    assert tmesh.production_shape(256) == {"data": 16, "model": 16}
    assert tmesh.production_shape(512, True) == {"pod": 2, "data": 16,
                                                 "model": 16}
    assert tmesh.production_shape(1) == {"data": 1, "model": 1}
    for world, mp in ((4, False), (512, False), (256, True), (8, True)):
        with pytest.raises(ValueError, match="16×16"):
            tmesh.production_shape(world, mp)
