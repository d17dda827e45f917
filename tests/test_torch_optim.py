"""The port's optimizer (``repro_torch.optim``) against the reference's
(``repro.optim``) on the same trees, on the CPU: the cosine schedule, the
global norm, ``adamw_update`` with float32 and bfloat16 parameters and
moments, weight decay by the rank of the reference's (stacked) leaf, and
int8 compression with one scale per reference leaf and error feedback."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro import optim as ropt
from repro.models import init_params as ref_init_params
from repro_torch import configs as tcfgs
from repro_torch import optim as topt
from repro_torch.models import params_from_jax
from repro_torch.models.convert import (from_reference_tree, leaf_map,
                                        reference_ndim, to_reference_tree,
                                        tree_to_numpy)


def np_tree(seed: int, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(dtype),
            "blocks": [{"scale": rng.normal(size=(5,)).astype(dtype),
                        "k": rng.normal(size=(3, 5, 2)).astype(dtype)}],
            "b": rng.normal(size=(7,)).astype(dtype)}


def to_jax(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def to_torch(tree, dtype=None):
    return jax.tree.map(lambda a: torch.tensor(a, dtype=dtype), tree)


def as_np(tree):
    return jax.tree.map(
        lambda x: x.float().numpy() if isinstance(x, torch.Tensor)
        else np.asarray(x, np.float32), tree)


@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 5000, 10000, 12000])
def test_cosine_schedule_matches_reference(step):
    for kw in ({}, {"warmup_steps": 0}, {"warmup_steps": 7,
                                         "total_steps": 50}):
        want = float(ropt.cosine_schedule(ropt.AdamWConfig(**kw),
                                          jnp.float32(step)))
        got = float(topt.cosine_schedule(topt.AdamWConfig(**kw),
                                         torch.tensor(float(step))))
        assert got == want, (kw, step, got, want)


def test_global_norm_matches_reference():
    tree = np_tree(1)
    want = float(ropt.global_norm(to_jax(tree)))
    got = float(topt.global_norm(to_torch(tree)))
    assert abs(got - want) <= 1e-6 * want
    bf = float(topt.global_norm(to_torch(tree, torch.bfloat16)))
    assert abs(bf - float(ropt.global_norm(to_jax(tree, jnp.bfloat16)))) \
        <= 1e-6 * bf


@pytest.mark.parametrize("pdtype,mdtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_adamw_update_matches_reference(pdtype, mdtype):
    """Three steps with gradients clipped (a norm past 1) and weight decay
    on the matrices: parameters, moments, step, grad_norm and lr equal the
    reference's (in float32 within 1e-5, the sums of squares rounding in
    another order; in bfloat16 storage within one bfloat16 rounding)."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[pdtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[pdtype]
    rc = ropt.AdamWConfig(warmup_steps=2, moment_dtype=mdtype)
    tc = topt.AdamWConfig(warmup_steps=2, moment_dtype=mdtype)
    rp, tp = to_jax(np_tree(0), jd), to_torch(np_tree(0), td)
    rs, ts = ropt.adamw_init(rp, rc), topt.adamw_init(tp, tc)
    for i in range(3):
        g = np_tree(10 + i)
        rp, rs, rm = ropt.adamw_update(rp, to_jax(g, jd), rs, rc)
        tp, ts, tm = topt.adamw_update(tp, to_torch(g, td), ts, tc)
        assert float(tm["lr"]) == float(rm["lr"])
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= \
            1e-6 * float(rm["grad_norm"])
        assert float(rm["grad_norm"]) > 1.0        # clipping applies
    assert int(ts["step"]) == int(rs["step"]) == 3
    assert ts["mu"]["w"].dtype == (torch.bfloat16 if mdtype == "bfloat16"
                                   else torch.float32)
    tol = 1e-5 if pdtype == mdtype == "float32" else 2.0 ** -7
    for want, got in ((rp, tp), (rs["mu"], ts["mu"]), (rs["nu"], ts["nu"])):
        for a, b in zip(jax.tree.leaves(as_np(want)),
                        jax.tree.leaves(as_np(got))):
            np.testing.assert_allclose(b, a, rtol=tol, atol=1e-30)


def test_decay_follows_the_reference_leaf_rank():
    """A stacked tree (Zamba2's smoke config: Mamba2's ``A_log``, ``D``,
    ``dt_bias`` and every norm scale a 1-D tensor a layer in the port, a
    2-D leaf in the reference): with each leaf's reference rank the port's
    step ≡ the reference's on its own tree, and those per-layer vectors
    are decayed; by the port's own ranks they would not be."""
    cfg = rcfgs.get_smoke_config("zamba2_2p7b")
    tcfg = tcfgs.get_smoke_config("zamba2_2p7b")
    params, _ = ref_init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    grads = jax.tree.map(
        lambda p: rng.normal(size=p.shape).astype(np.float32) * 1e-2,
        params)
    rc = ropt.AdamWConfig(warmup_steps=0, weight_decay=0.5)
    tc = topt.AdamWConfig(warmup_steps=0, weight_decay=0.5)
    want, _, _ = ropt.adamw_update(params, to_jax(grads), ropt.adamw_init(
        params, rc), rc)

    def port_step(by_reference: bool):
        model = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")
        named = dict(model.named_parameters())
        g = {n: torch.from_numpy(np.ascontiguousarray(v)) for n, v in
             from_reference_tree(tcfg, grads, named).items()}
        ndim = reference_ndim(tcfg, named) if by_reference else None
        topt.adamw_update(named, g, topt.adamw_init(named, tc), tc, ndim)
        return tree_to_numpy(to_reference_tree(tcfg, named))

    got = port_step(True)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert sorted(map(str, flat_w)) == sorted(map(str, flat_g))
    for k, v in flat_w.items():
        np.testing.assert_allclose(flat_g[k], np.asarray(v), rtol=0,
                                   atol=1e-6, err_msg=str(k))
    named = dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu").named_parameters())
    ndim = reference_ndim(tcfg, named)
    vectors = [n for n, p in named.items() if p.dim() == 1 and ndim[n] == 2]
    assert any(".A_log" in n for n in vectors) and any(
        ".ln1.scale" in n for n in vectors)
    assert ndim["final_norm.scale"] == 1
    own = port_step(False)
    apart = [k for k, v in dict(jax.tree_util.tree_flatten_with_path(
        own)[0]).items() if not np.allclose(v, flat_g[k], rtol=0,
                                            atol=1e-7)]
    assert apart and all("A_log" in str(k) or "scale" in str(k) or
                         "D" in str(k) or "dt_bias" in str(k) or
                         "conv_b" in str(k) for k in apart), apart


def test_compression_scales_by_reference_leaf():
    """int8 compression of Granite's smoke gradients: one scale a
    reference leaf (shared by a segment's layers), levels and the error
    ≡ the reference's bit for bit over two steps of error feedback; the
    decompressed gradients too."""
    cfg = rcfgs.get_smoke_config("granite_moe_1b")
    tcfg = tcfgs.get_smoke_config("granite_moe_1b")
    params, _ = ref_init_params(cfg, jax.random.PRNGKey(0))
    named = dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu").named_parameters())
    groups = {n: ref for n, (ref, _) in leaf_map(tcfg, named).items()}
    assert len(set(groups.values())) < len(groups)    # shared scales
    r_err, t_err = None, None
    for i in range(2):
        rng = np.random.default_rng(20 + i)
        grads = jax.tree.map(
            lambda p: (rng.normal(size=p.shape) *
                       rng.uniform(1e-3, 1.0)).astype(np.float32), params)
        rcomp, r_err = ropt.compress_gradients(to_jax(grads), r_err)
        tg = {n: torch.from_numpy(np.ascontiguousarray(v)) for n, v in
              from_reference_tree(tcfg, grads, named).items()}
        tcomp, t_err = topt.compress_gradients(tg, t_err, groups)
        for part, want in (("q", rcomp["q"]),
                           ("deq", ropt.decompress_gradients(rcomp))):
            got = (tcomp["q"] if part == "q" else
                   topt.decompress_gradients(tcomp))
            got = tree_to_numpy(to_reference_tree(tcfg, {
                n: v.float() for n, v in got.items()}))
            for (k, a), (_, b) in zip(
                    jax.tree_util.tree_flatten_with_path(want)[0],
                    jax.tree_util.tree_flatten_with_path(got)[0]):
                np.testing.assert_array_equal(
                    b, np.asarray(a, np.float32), err_msg=f"{part} {k}")
        got_err = tree_to_numpy(to_reference_tree(tcfg, t_err))
        for a, b in zip(jax.tree.leaves(r_err), jax.tree.leaves(got_err)):
            np.testing.assert_array_equal(b, np.asarray(a))
        # one scale a reference leaf
        for n, s in tcomp["scale"].items():
            rk = groups[n]
            same = [tcomp["scale"][m] for m in groups if groups[m] == rk]
            assert all(float(x) == float(s) for x in same)
    assert tcomp["q"]["blocks.0.moe.wi"].dtype == torch.int8
