"""The port's distributed CER (``repro_torch.vector.distributed``,
``repro_torch.launch``, ``restore_resharded``) against the reference
package at world size 1, on the CPU: the tests of
``tests/test_distributed_cer.py`` and the sharded case of
``tests/test_partitioned_stream.py`` over both packages, with the same
seeds and numpy inputs, ``repro`` on ``make_host_mesh()`` and the port on
its world-1 gloo group.  Exact equality throughout.  The 2- and 4-rank
runs are in ``tests/test_torch_distributed_ranks.py``.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import restore_resharded as j_restore_resharded
from repro.core import Event as JEvent
from repro.core import compile_query as j_compile_query
from repro.core.engine import Engine as JEngine
from repro.core.engine import WindowSpec as JWindowSpec
from repro.core.partition import PartitionedEngine as JPartitionedEngine
from repro.jaxcompat import make_mesh as j_make_mesh
from repro.kernels import ops as jops
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.launch.mesh import use_mesh
from repro.vector import PartitionedStreamingEngine as JPartitioned
from repro.vector import VectorEngine as JVectorEngine
from repro.vector import distributed as jdist
from repro_torch.checkpoint import (CheckpointManager, LaneShard,
                                    restore_resharded)
from repro_torch.core.events import Event
from repro_torch.core.partition import NULL_KEY_HASH
from repro_torch.kernels import ops
from repro_torch.launch import cer_dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.vector import PartitionedStreamingEngine, VectorEngine
from repro_torch.vector import distributed as dist_

QTEXT = "SELECT * FROM S WHERE A ; B+ ; C"
FAULT_QUERY = ("SELECT * FROM S WHERE A AS a ; B AS b "
               "FILTER a[price > 5.0] WITHIN 8 events")


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = make_host_mesh(str(tmp_path_factory.mktemp("group") / "store"))
    yield g
    g.close()


def np_(x):
    """numpy of a jax array or a tensor (uint32 tensors by their bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32).numpy().view(np.uint32)
        return x.numpy()
    return np.asarray(x)


def assert_same(a, b):
    a, b = np_(a), np_(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def tiny_tables():
    rng = np.random.default_rng(3)
    S, C = 5, 4
    M = np.zeros((C, S, S), np.float32)
    for s in range(1, S):
        for c in range(C):
            M[c, s, rng.integers(1, S)] += 1
    finals = np.zeros(S, np.float32)
    finals[S - 1] = 1
    return M, finals


def test_sharded_scan_matches_local(group):
    M, finals = tiny_tables()
    T, B, eps = 20, 4, 5
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 4, (T, B)).astype(np.int32)
    W = jops.ring_size(eps)
    mesh = j_host_mesh()
    with use_mesh(mesh):
        m_j, c_j = jdist.sharded_cea_scan(
            mesh, jnp.asarray(ids), jnp.asarray(M), jnp.asarray(finals),
            jnp.zeros((B, W, 5), jnp.float32), epsilon=eps)
    m_t, c_t = dist_.sharded_cea_scan(
        group, torch.from_numpy(ids), torch.from_numpy(M),
        torch.from_numpy(finals), torch.zeros((B, W, 5)), epsilon=eps)
    m_l, c_l = ops.cea_scan(torch.from_numpy(ids), torch.from_numpy(M),
                            torch.from_numpy(finals), torch.zeros((B, W, 5)),
                            epsilon=eps)
    for got, want in ((m_t, m_j), (c_t, c_j), (m_t, m_l), (c_t, c_l)):
        assert_same(got, want)
    assert np_(m_t).sum() > 0


def test_sharded_pipeline_matches_local_fused(group):
    """Sharded fused pipeline ≡ ``repro``'s sharded Pallas pipeline
    (interpret mode) ≡ the local pipeline, at a start position of 3."""
    rng = np.random.default_rng(7)
    S, C, A, k = 5, 4, 3, 4
    specs = tuple((int(rng.integers(0, A)), int(rng.integers(0, 6)),
                   float(rng.normal())) for _ in range(k))
    class_of = rng.integers(0, C, 1 << k).astype(np.int32)
    M, finals = tiny_tables()
    init = np.zeros(S, np.float32)
    init[1] = 1.0
    T, B, eps = 18, 4, 5
    attrs = rng.normal(size=(T, B, A)).astype(np.float32)
    W = jops.ring_size(eps)
    mesh = j_host_mesh()
    with use_mesh(mesh):
        m_j, c_j = jdist.sharded_cer_pipeline(
            mesh, jnp.asarray(attrs), specs, jnp.asarray(class_of),
            jops.class_indicator(class_of, C), jnp.asarray(M),
            jnp.asarray(finals)[None, :], jnp.zeros((B, W, S), jnp.float32),
            init_mask=jnp.asarray(init), epsilon=eps, start_pos=3,
            impl="fused", use_pallas=True)
    t = torch.from_numpy
    kw = dict(init_mask=t(init), epsilon=eps, start_pos=3)
    args = (t(attrs), specs, t(class_of), ops.class_indicator(class_of, C),
            t(M), t(finals)[None, :], torch.zeros((B, W, S)))
    m_t, c_t = dist_.sharded_cer_pipeline(group, *args, **kw)
    m_l, c_l = ops.cer_pipeline(*args, impl="ref", **kw)
    for got, want in ((m_t, m_j), (c_t, c_j), (m_t, m_l), (c_t, c_l)):
        assert_same(got, want)


def _routed_feed_counts(stream, route, feed, chunk):
    """Per-position counts and hits of chunks routed and fed."""
    got = np.zeros(len(stream), np.int64)
    hits = []
    for lo in range(0, len(stream), chunk):
        *routed, valid, keep = route(lo)
        p2 = np_(routed[2])
        counts, h = feed(routed)
        v = np_(valid)
        got[p2[v]] = np.asarray(counts)[v]
        hits += h
    return got, sorted(hits)


def test_sharded_time_window_parity_with_host(group):
    """``route_partitioned_chunk`` with shipped timestamps, NULL keys
    included: the port's routed chunk ≡ ``repro``'s, and the port's local
    step over it ≡ the host ``PartitionedEngine``'s time windows."""
    qtext = "SELECT * FROM S WHERE A ; B+ ; C WITHIN 12 seconds"
    rng = random.Random(19)
    t, raw = 0, []
    for _ in range(64):
        t += rng.randint(1, 2)
        raw.append((rng.choice("ABC"), {} if rng.random() < 0.1
                    else {"uid": rng.choice(["a", "b", None])}, float(t)))
    q = j_compile_query(qtext)
    pe = JPartitionedEngine(
        lambda: JEngine(q.cea, window=JWindowSpec.time(12.0)), ("uid",))
    want = [len(pe.process(JEvent(ty, a, timestamp=ts)))
            for ty, a, ts in raw]
    assert sum(want) > 0
    stream = [Event(ty, a, timestamp=ts) for ty, a, ts in raw]
    ve = VectorEngine(qtext, max_window_events=16, device="cpu")
    pse = PartitionedStreamingEngine(ve, ("uid",), chunk_len=16, num_lanes=8)
    jve = JVectorEngine(qtext, max_window_events=16)
    mesh = j_host_mesh()

    def route(lo):
        attrs, keys, ts = ve.encoder.encode_stream_keyed_ts(
            stream[lo:lo + 16], ("uid",))
        pos = np.arange(lo, lo + 16, dtype=np.int32)
        jattrs, jkeys, jts = jve.encoder.encode_stream_keyed_ts(
            [JEvent(ty, a, timestamp=tt) for ty, a, tt in raw[lo:lo + 16]],
            ("uid",))
        np.testing.assert_array_equal(jkeys, keys)
        with use_mesh(mesh):
            want_r = jdist.route_partitioned_chunk(
                mesh, jnp.asarray(jattrs), jnp.asarray(jkeys),
                jnp.asarray(pos), jnp.asarray(jts))
        got = dist_.route_partitioned_chunk(
            group, torch.from_numpy(attrs), keys, torch.from_numpy(pos),
            torch.from_numpy(ts))
        for a, b in zip(got, want_r):
            assert_same(a, b)
        assert_same(got[-1],
                    torch.from_numpy(keys != np.uint32(NULL_KEY_HASH)))
        return got

    def feed(r):
        return pse.feed_keyed(r[0], r[1], positions=np_(r[2]), event_ts=r[3])

    got, hits = _routed_feed_counts(stream, route, feed, 16)
    assert got.tolist() == want
    assert hits == [j for j, c in enumerate(want) if c > 0]


def test_router_single_shard_identity_up_to_capacity(group):
    """On one rank the router is a bucket compaction: every event lands
    in a slot of its own bucket, in the reference's order."""
    N, A = 16, 3
    rng = np.random.default_rng(1)
    events = rng.normal(size=(N, A)).astype(np.float32)
    keys = rng.integers(0, 100, (N,)).astype(np.int32)
    mesh = j_host_mesh()
    with use_mesh(mesh):
        r_j, k_j = jdist.route_by_partition(mesh, jnp.asarray(events),
                                            jnp.asarray(keys))
    r_t, k_t = dist_.route_by_partition(group, torch.from_numpy(events),
                                        torch.from_numpy(keys))
    assert_same(r_t, r_j)
    assert_same(k_t, k_j)
    assert np_(k_t).all()
    routed = np_(r_t)
    for i in range(N):
        assert any(np.array_equal(events[i], routed[j]) for j in range(N))


def make_stream(seed, T, alphabet="ABCX", keys=("u1", "u2", 7, 7.0, None),
                p_missing=0.05):
    rng = random.Random(seed)
    out = []
    for _ in range(T):
        attrs = {} if rng.random() < p_missing else \
            {"uid": rng.choice(keys)}
        out.append((rng.choice(alphabet), attrs))
    return out


def host_counts(qtext, raw, window, key_attrs=("uid",)):
    q = j_compile_query(qtext)
    pe = JPartitionedEngine(lambda: JEngine(q.cea, window=window),
                            tuple(key_attrs))
    return [len(pe.process(JEvent(ty, a))) for ty, a in raw]


def test_sharded_route_then_local_step_matches_host(group):
    """One collective (the router), then the local step: both packages'
    routed chunks are equal, and the port's feed ≡ the host engine."""
    raw = make_stream(41, 32)
    want = host_counts(QTEXT, raw, JWindowSpec.events(5))
    stream = [Event(ty, a) for ty, a in raw]
    ve = VectorEngine(QTEXT, epsilon=5, device="cpu")
    pse = PartitionedStreamingEngine(ve, ("uid",), chunk_len=16, num_lanes=8)
    mesh = j_host_mesh()

    def route(lo):
        attrs, keys = ve.encoder.encode_stream_with_keys(
            stream[lo:lo + 16], ("uid",))
        pos = np.arange(lo, lo + 16, dtype=np.int32)
        with use_mesh(mesh):
            want_r = jdist.route_partitioned_chunk(
                mesh, jnp.asarray(attrs), jnp.asarray(keys),
                jnp.asarray(pos))
        got = dist_.route_partitioned_chunk(
            group, torch.from_numpy(attrs), keys, torch.from_numpy(pos))
        for a, b in zip(got, want_r):
            assert_same(a, b)
        # NULL keys drop sender-side; everything else fits on one rank
        assert_same(got[-1],
                    torch.from_numpy(keys != np.uint32(NULL_KEY_HASH)))
        return got

    def feed(r):
        return pse.feed_keyed(r[0], r[1], positions=np_(r[2]))

    got, hits = _routed_feed_counts(stream, route, feed, 16)
    assert got.tolist() == want
    assert hits == [j for j, c in enumerate(want) if c > 0]


def fault_stream(n=64, seed=6):
    """A quarter of the events carry neither ``uid`` nor ``price``: the
    router drops them (NULL key) and the encoder writes NaN for the price."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        attrs = {} if rng.random() < 0.25 else \
            {"uid": rng.choice(["u1", "u2", "u3"]),
             "price": float(rng.randint(0, 10))}
        out.append((rng.choice("AB"), attrs))
    return out


def test_router_does_not_copy_the_reference_nan_fault(group):
    """A dropped row carrying NaN.  The reference adds ``x · keep`` into a
    clipped slot of its destination, so ``NaN · 0`` poisons the kept event
    owning that slot; the port writes kept rows only.  The port's routed
    rows equal the closed form (kept rows in order, then zero rows),
    ``repro``'s differ in the shared slot, and the port's route and feed
    of a stream whose NULL-keyed events lack the filtered attribute ≡ the
    host ``PartitionedEngine``, where ``repro``'s loses matches."""
    ev = np.array([[1, 2], [np.nan, 5], [3, 4], [6, 7]], np.float32)
    keys = np.array([3, 1, 4, 1], np.int32)
    drop = np.array([False, True, False, False])
    closed = np.concatenate([ev[~drop], np.zeros((1, 2), np.float32)])
    r_t, k_t = dist_.route_by_partition(group, torch.from_numpy(ev),
                                        torch.from_numpy(keys),
                                        drop=torch.from_numpy(drop))
    np.testing.assert_array_equal(np_(r_t), closed)
    mesh = j_host_mesh()
    with use_mesh(mesh):
        r_j, k_j = jdist.route_by_partition(
            mesh, jnp.asarray(ev), jnp.asarray(keys), drop=jnp.asarray(drop))
    r_j = np.asarray(r_j)
    assert_same(k_t, k_j)
    assert np.isnan(r_j[0, 0]) and r_j[0, 1] == 2.0      # the shared slot
    np.testing.assert_array_equal(r_j[1:], closed[1:])

    raw = fault_stream()
    want = host_counts(FAULT_QUERY, raw, JWindowSpec.events(8))
    stream = [Event(ty, a) for ty, a in raw]
    ve = VectorEngine(FAULT_QUERY, device="cpu")
    pse = PartitionedStreamingEngine(ve, ("uid",), chunk_len=16, num_lanes=8)
    jve = JVectorEngine(FAULT_QUERY)
    jpse = JPartitioned(jve, ("uid",), chunk_len=16, num_lanes=8)
    chunks = {}

    def route(lo):
        attrs, keys = ve.encoder.encode_stream_with_keys(
            stream[lo:lo + 16], ("uid",))
        assert np.isnan(attrs[keys == np.uint32(NULL_KEY_HASH)]).any()
        pos = torch.arange(lo, lo + 16, dtype=torch.int32)
        chunks[lo] = (attrs, keys, pos.numpy())
        return dist_.route_partitioned_chunk(group, torch.from_numpy(attrs),
                                             keys, pos)

    def feed(r):
        return pse.feed_keyed(r[0], r[1], positions=np_(r[2]))

    got, hits = _routed_feed_counts(stream, route, feed, 16)
    assert got.tolist() == want and sum(want) > 0
    assert hits == [j for j, c in enumerate(want) if c > 0]

    def j_route(lo):
        attrs, keys, pos = chunks[lo]
        with use_mesh(mesh):
            return jdist.route_partitioned_chunk(
                mesh, jnp.asarray(attrs), jnp.asarray(keys),
                jnp.asarray(pos))

    def j_feed(r):
        return jpse.feed_keyed(r[0], r[1], positions=np.asarray(r[2]))

    j_got, _ = _routed_feed_counts(stream, j_route, j_feed, 16)
    assert j_got.sum() < got.sum()


def test_elastic_restore_resharded(tmp_path, group):
    """A checkpoint restores onto another group (``tests/test_runtime.py``'s
    case): both packages read the port's checkpoint, the port places the
    leaf as its rank's block or whole on a device."""
    ckpt = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(16.0).reshape(4, 4),
            "keys": torch.tensor([1, 2], dtype=torch.int32).view(
                torch.uint32)}
    ckpt.save(5, tree, extra={"note": "x"})
    placed, extra = restore_resharded(
        ckpt, tree, {"w": LaneShard(group, 0), "keys": torch.device("cpu")})
    assert extra == {"note": "x"}
    assert placed["w"].device == group.device
    np.testing.assert_array_equal(placed["w"].numpy(),
                                  np.arange(16.0).reshape(4, 4))
    assert placed["keys"].dtype == torch.uint32
    assert_same(placed["keys"], tree["keys"])
    mesh = j_make_mesh((1,), ("data",))
    shardings = {"w": jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("data", None)),
        "keys": jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec())}
    j_tree = {"w": jnp.zeros((4, 4)), "keys": jnp.zeros(2, jnp.uint32)}
    restored, _ = j_restore_resharded(JCheckpointManager(str(tmp_path)),
                                      j_tree, shardings)
    np.testing.assert_array_equal(np.asarray(restored["w"]),
                                  placed["w"].numpy())
    np.testing.assert_array_equal(np.asarray(restored["keys"]),
                                  np_(placed["keys"]))
    with pytest.raises(ValueError, match="placements"):
        restore_resharded(ckpt, tree, {"w": torch.device("cpu")})


def test_entry_points_refuse_without_a_card(group, tmp_path, monkeypatch):
    """The production group and the dry run run on CUDA unless asked for
    the CPU, and raise without a card; blocks must lie on the group's
    device, and a router block must split into equal buckets."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_production_mesh(str(tmp_path / "store"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cer_dryrun.main(["--streams", "8", "--chunk", "4"])
    with pytest.raises(ValueError, match="holds its blocks"):
        dist_.route_by_partition(group, torch.zeros((4, 2), device="meta"),
                                 torch.zeros(4, dtype=torch.int32))
    two = type(group)(0, 2, group.device, "gloo", group.group)
    with pytest.raises(ValueError, match="divisible"):
        dist_.route_by_partition(two, torch.zeros((3, 2)),
                                 torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="equal blocks"):
        two.block(torch.zeros(3))
