"""The port's training (``repro_torch.models.steps``, ``optim``,
``runtime.trainer``, ``data.tokens``, the checkpoint manager's bfloat16
leaves) against the reference package on the CPU.

For each of the ten archs at its smoke config (float32, off the mesh, so
that MoE takes ``_moe_global`` at a capacity where nothing overflows):
``loss_fn``'s metrics, every gradient mapped into the reference's tree
(``to_reference_tree``, the map of ``params_to_jax``) and one train step
(AdamW, decay and, for one arch, int8 compression scales by reference
leaf) equal ``repro``'s on the same weights and batch within 1e-5.  Then
the counterparts of ``tests/test_runtime.py``'s trainer tests, checkpoints
read across packages (bfloat16 leaves byte for byte) and the token
pipeline's determinism.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.models import init_params as ref_init_params
from repro.models import init_train_state as ref_init_train_state
from repro.models import steps as rsteps
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import compress_gradients as ref_compress
from repro.optim import decompress_gradients as ref_decompress
from repro_torch import configs as tcfgs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import compile_query
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import (init_train_state, loss_fn, make_train_step,
                                params_from_jax, params_to_jax, state_tree)
from repro_torch.models.convert import (leaf_map, to_reference_tree,
                                       tree_to_numpy)
from repro_torch.optim import AdamWConfig, compress_gradients
from repro_torch.runtime import Trainer, TrainerConfig

B, S = 2, 16
COMPRESS_ARCH = "granite_moe_1b"
TOL = 1e-5


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def close_trees(ref, port, tol=TOL, what="", skip=None):
    """The same leaves, shapes and values within ``tol`` of the larger of
    1 and the leaf's largest magnitude; ``skip`` (key → mask) leaves
    elements out."""
    a, b = flat(ref), flat(port)
    assert sorted(a) == sorted(b), (what, sorted(set(a) ^ set(b)))
    for k in a:
        assert a[k].shape == b[k].shape, (what, k, a[k].shape, b[k].shape)
        d = np.abs(a[k].astype(np.float64) - b[k])
        if skip is not None and k in skip:
            d = np.where(skip[k], 0.0, d)
        err = float(d.max()) if a[k].size else 0.0
        assert err <= tol * max(1.0, float(np.abs(a[k]).max())), \
            (what, k, err)


def batch_np(cfg, seed=6):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["patches"] = rng.normal(
            size=(B, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    return batch


# The step's direction at step 1 is g / (|g| + eps): where |g| is near
# eps the two packages' gradients, equal to about 1e-9, would give
# directions apart by up to (1e-9 / eps) of the learning rate.  eps 1e-6
# keeps that below 1e-3 of it, so the comparison at 1e-5 tests the update
# (3e-4 of a full learning rate a parameter) and not rounding.
OPT = dict(warmup_steps=1, total_steps=100, eps=1e-6)


@pytest.fixture(scope="module", params=rcfgs.ARCHS)
def train_runs(request):
    """One arch: the reference's loss, gradients and train step (its
    ``loss_fn`` under ``jax.value_and_grad``, then the optimizer as
    ``make_train_step`` composes it) and the port's, from the same
    weights and batch."""
    arch = request.param
    cfg, tcfg = rcfgs.get_smoke_config(arch), tcfgs.get_smoke_config(arch)
    compress = arch == COMPRESS_ARCH
    params, _ = ref_init_params(cfg, jax.random.PRNGKey(0))
    batch = batch_np(cfg)
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: rsteps.loss_fn(p, cfg, b), has_aux=True))(params,
                                                                rbatch)
    opt = RefAdamWConfig(**OPT)
    g, err = grads, None
    if compress:
        comp, err = ref_compress(grads, jax.tree.map(
            lambda p: jnp.zeros_like(p, jnp.float32), params))
        g = ref_decompress(comp)
    new_p, new_opt, om = ref_adamw_update(params, g,
                                          ref_adamw_init(params, opt), opt)
    ref = {"q": None if err is None else to_np(comp["q"]),
           "g_over_scale": None if err is None else jax.tree.map(
               lambda g, sc: np.asarray(g, np.float64) / float(sc),
               to_np(grads), to_np(comp["scale"])),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": to_np(grads), "params": to_np(new_p),
           "mu": to_np(new_opt["mu"]), "nu": to_np(new_opt["nu"]),
           "grad_norm": float(om["grad_norm"]), "lr": float(om["lr"]),
           "err": None if err is None else to_np(err)}

    model = params_from_jax(to_np(params), tcfg, "cpu")
    _, tmetrics = loss_fn(model, tcfg, tbatch)
    tmetrics["loss"].backward()
    named_grads = {n: p.grad for n, p in model.named_parameters()}
    tgrads = tree_to_numpy(to_reference_tree(tcfg, named_grads))
    tq = None
    if compress:
        groups = {n: ref for n, (ref, _) in
                  leaf_map(tcfg, named_grads).items()}
        tq = tree_to_numpy(to_reference_tree(tcfg, {
            n: q.float() for n, q in compress_gradients(
                named_grads, None, groups)[0]["q"].items()}))
    topt = AdamWConfig(**OPT)
    from repro_torch.optim import adamw_init
    state = {"params": model, "opt": adamw_init(
        dict(model.named_parameters()), topt)}
    if compress:
        state["err"] = {n: torch.zeros_like(p) for n, p in
                        model.named_parameters()}
    state, sm = make_train_step(tcfg, topt, compress=compress)(state,
                                                               tbatch)
    tree = tree_to_numpy(state_tree(state, tcfg))
    port = {"metrics": {k: float(v.detach()) for k, v in tmetrics.items()},
            "step_metrics": {k: float(v) for k, v in sm.items()},
            "grads": tgrads, "params": tree["params"],
            "mu": tree["opt"]["mu"], "nu": tree["opt"]["nu"],
            "step": int(tree["opt"]["step"]), "err": tree.get("err"),
            "q": tq,
            "params_to_jax": params_to_jax(model, tcfg)}
    return arch, ref, port


def test_loss_metrics_match_reference(train_runs):
    arch, ref, port = train_runs
    assert sorted(ref["metrics"]) == sorted(port["metrics"])
    for k, v in ref["metrics"].items():
        assert abs(port["metrics"][k] - v) <= TOL * max(1.0, abs(v)), \
            (arch, k, v, port["metrics"][k])
        assert abs(port["step_metrics"][k] - v) <= TOL * max(1.0, abs(v))
    if arch in ("granite_moe_1b", "deepseek_v3_671b"):
        assert ref["metrics"]["aux"] > 0
    assert ("mtp" in ref["metrics"]) == (arch == "deepseek_v3_671b")


def test_gradients_match_reference(train_runs):
    arch, ref, port = train_runs
    close_trees(ref["grads"], port["grads"], what=arch)


def test_train_step_matches_reference(train_runs):
    """One AdamW step (with int8 compression and error feedback for one
    arch): parameters, both moments and the error tree in the
    reference's tree, and the gradient norm and learning rate."""
    arch, ref, port = train_runs
    sm = port["step_metrics"]
    assert abs(sm["grad_norm"] - ref["grad_norm"]) <= \
        TOL * max(1.0, ref["grad_norm"])
    assert abs(sm["lr"] - ref["lr"]) <= 1e-12 and port["step"] == 1
    skip = None
    assert (ref["err"] is None) == (port["err"] is None)
    if ref["err"] is not None:
        # int8 levels: equal but where g/scale lies within 1e-4 of a
        # rounding boundary (x.5), where a gradient equal to 1e-9 may
        # round to the next level; such elements move by one level and
        # are left out of the state comparisons below
        rq, tq, gs = flat(ref["q"]), flat(port["q"]), flat(
            ref["g_over_scale"])
        assert sorted(rq) == sorted(tq)
        skip = {}
        for k in rq:
            apart = rq[k].astype(np.float64) != tq[k]
            near = np.abs(np.abs(gs[k]) % 1.0 - 0.5) < 1e-4
            assert not (apart & ~near).any(), (arch, k)
            assert np.abs(rq[k] - tq[k]).max() <= 1
            skip[k] = apart
        assert sum(int(m.sum()) for m in skip.values()) <= 4
        close_trees(ref["err"], port["err"], what=arch, skip=skip)
    close_trees(ref["mu"], port["mu"], what=arch, skip=skip)
    close_trees(ref["nu"], port["nu"], what=arch, skip=skip)
    close_trees(ref["params"], port["params"], what=arch, skip=skip)
    close_trees(ref["params"], port["params_to_jax"], what=arch, skip=skip)


# ---------------------------------------------------------------------------
# the Trainer (tests/test_runtime.py's trainer tests, against the reference)
# ---------------------------------------------------------------------------

MONITOR = ("SELECT * FROM S WHERE STEP AS a ; STEP AS b "
           "FILTER a[grad_norm > 0] AND b[grad_norm > 0] WITHIN 10 events")


class NumpyData:
    """The same batches for both packages: tokens from ``(seed, step)``
    with numpy, wrapped for one package."""

    def __init__(self, vocab: int, wrap, seed: int = 1):
        self.vocab, self.wrap, self.seed = vocab, wrap, seed

    def batch_at(self, step: int):
        rng = np.random.default_rng([self.seed, step])
        return {"tokens": self.wrap(rng.integers(0, self.vocab, (2, 16)))}


def trainer_opt(cls):
    # a fixed schedule horizon, as tests/test_runtime.py's: resume and the
    # straight run see the same learning rates
    return cls(total_steps=100, warmup_steps=0)


@pytest.fixture(scope="module")
def ref_trainer(tmp_path_factory):
    """The reference's Trainer over 8 steps (checkpoints every 2) with the
    CER monitor: its losses and matches."""
    from repro.core import compile_query as ref_compile_query
    from repro.runtime import Trainer as RefTrainer
    from repro.runtime import TrainerConfig as RefTrainerConfig
    cfg = rcfgs.get_smoke_config("qwen3_32b")
    opt = trainer_opt(RefAdamWConfig)
    state, _ = ref_init_train_state(cfg, opt, jax.random.PRNGKey(0))
    params0 = to_np(state["params"])
    step = jax.jit(rsteps.make_train_step(cfg, opt))
    tr = RefTrainer(step, state, NumpyData(cfg.vocab_size, jnp.asarray),
                    RefTrainerConfig(total_steps=8, checkpoint_every=2,
                                     checkpoint_dir=str(
                                         tmp_path_factory.mktemp("ref")),
                                     async_checkpoint=False),
                    monitors=[ref_compile_query(MONITOR).make_executor()])
    tr.run()
    return {"params0": params0, "losses": [m["loss"] for m in
                                           tr.metrics_log],
            "matches": len(tr.matches), "params": to_np(tr.state["params"])}


def make_trainer(ref_trainer, directory, total_steps=6, fail_at=None,
                 monitors=None):
    """tests/test_runtime.py's make_trainer on the port: the qwen3_32b
    smoke config from the reference's initial weights."""
    tcfg = tcfgs.get_smoke_config("qwen3_32b")
    opt = trainer_opt(AdamWConfig)
    from repro_torch.optim import adamw_init
    model = params_from_jax(ref_trainer["params0"], tcfg, "cpu")
    state = {"params": model,
             "opt": adamw_init(dict(model.named_parameters()), opt)}
    raw_step = make_train_step(tcfg, opt)
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if fail_at is not None and calls["n"] == fail_at:
            raise RuntimeError("injected transient failure")
        return raw_step(state, batch)

    tc = TrainerConfig(total_steps=total_steps, checkpoint_every=2,
                       checkpoint_dir=str(directory), async_checkpoint=False,
                       max_restores=2)
    data = NumpyData(tcfg.vocab_size, torch.from_numpy)
    return Trainer(step_fn, state, data, tc, monitors=monitors or []), calls


def losses_of(tr):
    return [m["loss"] for m in tr.metrics_log]


def test_trainer_runs_and_checkpoints(ref_trainer, tmp_path):
    tr, _ = make_trainer(ref_trainer, tmp_path)
    report = tr.run()
    assert report["final_step"] == 6
    assert CheckpointManager(str(tmp_path)).latest_step() == 6
    np.testing.assert_allclose(losses_of(tr), ref_trainer["losses"][:6],
                               rtol=TOL)


def test_trainer_survives_transient_failure(ref_trainer, tmp_path):
    """A failing step is retried (same step, same batch), and training
    ends at the unperturbed run's loss."""
    tr_ok, _ = make_trainer(ref_trainer, tmp_path / "a")
    tr_ok.run()
    tr_fail, calls = make_trainer(ref_trainer, tmp_path / "b", fail_at=3)
    rep = tr_fail.run()
    assert rep["final_step"] == 6
    assert calls["n"] == 7  # one retry
    assert losses_of(tr_fail) == losses_of(tr_ok)
    np.testing.assert_allclose(losses_of(tr_fail)[-1],
                               ref_trainer["losses"][5], rtol=TOL)


def test_trainer_resume_from_checkpoint(ref_trainer, tmp_path):
    """Stop after step 4, resume in a new Trainer → the straight run's
    state; its losses the reference's."""
    tr1, _ = make_trainer(ref_trainer, tmp_path, total_steps=4)
    tr1.run()
    tr2, _ = make_trainer(ref_trainer, tmp_path, total_steps=8)
    rep = tr2.run(resume=True)
    assert rep["final_step"] == 8
    tr3, _ = make_trainer(ref_trainer, tmp_path / "straight", total_steps=8)
    tr3.run()
    for (n, a), b in zip(tr2.state["params"].named_parameters(),
                         tr3.state["params"].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-5, err_msg=n)
    assert int(tr2.state["opt"]["step"]) == 8
    np.testing.assert_allclose(losses_of(tr1) + losses_of(tr2),
                               ref_trainer["losses"], rtol=TOL)
    close_trees(ref_trainer["params"], params_to_jax(
        tr2.state["params"], tr2.state["params"].cfg), tol=1e-4)


def test_cer_training_monitor(ref_trainer, tmp_path):
    """The engine as a training monitor: two grad-norm events within 10
    steps fire on every pair, as many times as the reference's."""
    q = compile_query(MONITOR)
    tr, _ = make_trainer(ref_trainer, tmp_path, total_steps=8,
                         monitors=[q.make_executor()])
    tr.run()
    assert len(tr.matches) > 0
    assert len(tr.matches) == ref_trainer["matches"]


# ---------------------------------------------------------------------------
# checkpoints across packages, bfloat16 leaves byte for byte
# ---------------------------------------------------------------------------


def bf16_cfgs():
    kw = dict(param_dtype="bfloat16", opt_state_dtype="bfloat16")
    return (dataclasses.replace(rcfgs.get_smoke_config("qwen2p5_14b"), **kw),
            dataclasses.replace(tcfgs.get_smoke_config("qwen2p5_14b"), **kw))


def words(x) -> np.ndarray:
    """The raw 16-bit words of a bfloat16 array, tensor or ``V2`` array."""
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16).numpy()
    x = np.asarray(x)
    return np.ascontiguousarray(x).view(np.int16) if x.dtype.itemsize == 2 \
        else x


def test_port_checkpoint_restores_in_reference(tmp_path):
    """The port's bf16 train state (params and moments in bf16) written
    in the reference's tree; the reference reads every leaf, bf16 ones as
    the same words and "bfloat16" in its manifest."""
    cfg, tcfg = bf16_cfgs()
    opt = AdamWConfig(moment_dtype="bfloat16")
    state, _ = init_train_state(tcfg, opt, 3, compress=True, device="cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 16)))}
    state, _ = make_train_step(tcfg, opt, compress=True)(state, batch)
    tree = state_tree(state, tcfg)
    CheckpointManager(str(tmp_path)).save(1, tree, extra={"next_step": 1})
    ref_state, _ = ref_init_train_state(
        cfg, RefAdamWConfig(moment_dtype="bfloat16"), jax.random.PRNGKey(0),
        compress=True)
    template = jax.tree.map(
        lambda x: np.zeros(x.shape, "V2" if x.dtype == jnp.bfloat16
                           else x.dtype), ref_state)
    restored, extra = RefCheckpointManager(str(tmp_path)).restore(template)
    assert extra == {"next_step": 1}
    want = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path(restored)[0]}
    assert sorted(want) == sorted(got)
    n_bf16 = 0
    for k, v in want.items():
        if v.dtype == torch.bfloat16:
            n_bf16 += 1
            assert got[k].dtype == np.dtype("V2")
            np.testing.assert_array_equal(words(got[k]), words(v), k)
        else:
            np.testing.assert_array_equal(got[k], v.numpy(), k)
    assert n_bf16 > 0
    arrays, _ = RefCheckpointManager(str(tmp_path)).load_arrays()
    import json
    manifest = json.loads((tmp_path / "step_1" / "manifest.json")
                          .read_text())
    assert {leaf["dtype"] for leaf in manifest["leaves"]} == {
        "bfloat16", "float32", "int32"}


def test_reference_checkpoint_restores_in_port(tmp_path):
    """The reference's bf16 train state written by its manager; the port's
    Trainer restores it into its live state, every bf16 word equal."""
    cfg, tcfg = bf16_cfgs()
    ref_state, _ = ref_init_train_state(
        cfg, RefAdamWConfig(moment_dtype="bfloat16"), jax.random.PRNGKey(0))
    RefCheckpointManager(str(tmp_path)).save(4, ref_state,
                                             extra={"next_step": 4})
    opt = AdamWConfig(moment_dtype="bfloat16")
    state, _ = init_train_state(tcfg, opt, 5, device="cpu")
    tr = Trainer(lambda st, b: (st, {}), state, None,
                 TrainerConfig(total_steps=4, checkpoint_dir=str(tmp_path),
                               async_checkpoint=False))
    assert tr._restore(0) == 4
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path(state_tree(
               tr.state, tcfg))[0]}
    want = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(ref_state)[0]}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if v.dtype == jnp.bfloat16:
            assert got[k].dtype == torch.bfloat16, k
            np.testing.assert_array_equal(
                words(got[k]), np.asarray(v).view(np.int16), k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------


def test_token_pipeline_is_deterministic():
    """A batch is a function of (seed, step, shard) alone: the same from a
    new pipeline, another at another step or seed, each shard its own
    draw; frontend inputs drawn beside the tokens."""
    a = TokenPipeline(97, 4, 8, seed=3, frontend={"patches": (5, 6)},
                      device="cpu")
    b = TokenPipeline(97, 4, 8, seed=3, frontend={"patches": (5, 6)},
                      device="cpu")
    x = a.batch_at(7)
    assert x["tokens"].shape == (4, 8) and x["tokens"].dtype == torch.int64
    assert int(x["tokens"].min()) >= 0 and int(x["tokens"].max()) < 97
    assert x["patches"].shape == (4, 5, 6)
    assert x["patches"].dtype == torch.float32
    for k in x:
        assert torch.equal(x[k], b.batch_at(7)[k])
    assert not torch.equal(x["tokens"], a.batch_at(8)["tokens"])
    c = TokenPipeline(97, 4, 8, seed=4, device="cpu")
    assert not torch.equal(x["tokens"], c.batch_at(7)["tokens"])
    s0, s1 = a.batch_at(7, (0, 2)), a.batch_at(7, (1, 2))
    assert s0["tokens"].shape == (2, 8)
    assert not torch.equal(s0["tokens"], s1["tokens"])
    assert torch.equal(s0["tokens"], b.batch_at(7, (0, 2))["tokens"])
    first = next(iter(a))
    assert torch.equal(first["tokens"], a.batch_at(0)["tokens"])
    with pytest.raises(ValueError):
        a.batch_at(0, (0, 3))
