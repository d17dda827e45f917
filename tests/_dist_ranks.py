"""Inputs and rank processes of the multi-rank tests of the port's
distributed CER (``tests/test_torch_distributed_ranks.py``).

JAX-free: the spawned gloo ranks import this module, and so does the JAX
subprocess that computes the reference's values on the same inputs
(``tests/_dist_reference.py``).  Inputs are global numpy arrays made from
a seed; each rank takes its block, runs the port, and writes what the
test compares to ``rank<r>.npz`` (``rank<r>.err`` on failure).
"""
import os
import traceback
from datetime import timedelta

import numpy as np

NULL_KEY_HASH = 0xFFFFFFFF
A, P = 3, 2
SCAN_EPS, PIPE_EPS, PIPE_START = 5, 5, 3
TIMEOUT = timedelta(seconds=60)


def router_inputs(n: int, seed: int = 5) -> dict:
    """route_by_partition operands: N = 8·n² rows (a block of 8n, buckets
    of 8); negative keys; half the keys owned by rank 0, so its buckets
    spill past their capacity at n ≥ 2; a fifth of the rows dropped."""
    rng = np.random.default_rng(seed + n)
    N = 8 * n * n
    keys = rng.integers(-50, 50, N).astype(np.int32)
    hot = rng.random(N) < 0.5
    keys[hot] = n * rng.integers(-3, 3, int(hot.sum()))
    return {"events": rng.normal(size=(N, A)).astype(np.float32),
            "keys": keys, "drop": rng.random(N) < 0.2,
            "payload": rng.integers(-1000, 1000, (N, P)).astype(np.int32)}


def chunk_inputs(n: int, seed: int = 11) -> dict:
    """route_partitioned_chunk operands: N = 16·n² rows; uint32 hashes
    from a few keys (two of them ≥ 2^31) and NULL, so buckets spill at
    n ≥ 2; global positions and timestamps."""
    rng = np.random.default_rng(seed + n)
    N = 16 * n * n
    pool = np.array([3, 8, 0x80000001, 0xFFFFFFF0, 12345, 77],
                    np.uint32)
    keys = pool[rng.integers(0, len(pool), N)]
    keys[rng.random(N) < 0.15] = NULL_KEY_HASH
    attrs = rng.normal(size=(N, A)).astype(np.float32)
    return {"attrs": attrs, "keys": keys,
            "positions": (1000 + np.arange(N)).astype(np.int32),
            "ts": np.cumsum(rng.integers(1, 3, N)).astype(np.float32)}


def scan_inputs(seed: int = 3) -> dict:
    """The scans' operands (B = 8 lanes: blocks at 1, 2 and 4 ranks)."""
    rng = np.random.default_rng(seed)
    S, C, Apipe, k = 5, 4, 3, 4
    M = np.zeros((C, S, S), np.float32)
    for s in range(1, S):
        for c in range(C):
            M[c, s, rng.integers(1, S)] += 1
    finals = np.zeros(S, np.float32)
    finals[S - 1] = 1
    specs = np.array([(int(rng.integers(0, Apipe)), int(rng.integers(0, 6)),
                       float(np.float32(rng.normal()))) for _ in range(k)])
    init = np.zeros(S, np.float32)
    init[1] = 1.0
    return {"m_all": M, "finals": finals, "specs": specs,
            "class_of": rng.integers(0, C, 1 << k).astype(np.int32),
            "ids": rng.integers(0, C, (20, 8)).astype(np.int32),
            "attrs": rng.normal(size=(18, 8, Apipe)).astype(np.float32),
            "init_mask": init}


def _specs(arr) -> tuple:
    return tuple((int(c), int(o), float(t)) for c, o, t in arr)


def _route(g, out: dict) -> None:
    import torch

    from repro_torch.vector.distributed import (route_by_partition,
                                                route_partitioned_chunk)
    n = g.world_size
    x = {k: g.block(torch.from_numpy(v)) for k, v in
         router_inputs(n).items()}
    routed, pl, keep = route_by_partition(g, x["events"], x["keys"],
                                          payload=x["payload"],
                                          drop=x["drop"])
    out["route/routed"] = g.gather(routed)
    out["route/payload"] = g.gather(pl)
    out["route/keep"] = g.gather(keep)
    routed, keep = route_by_partition(g, x["events"], x["keys"])
    out["route_plain/routed"] = g.gather(routed)
    out["route_plain/keep"] = g.gather(keep)
    c = {k: g.block(torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                     else v))
         for k, v in chunk_inputs(n).items()}
    keys = c["keys"].view(torch.uint32)
    for tag, ts in (("chunk", None), ("chunk_ts", c["ts"])):
        res = route_partitioned_chunk(g, c["attrs"], keys, c["positions"],
                                      event_ts=ts)
        names = ["attrs", "keys", "positions"] + (["ts"] if ts is not None
                                                  else []) + ["valid", "keep"]
        for name, v in zip(names, res):
            out[f"{tag}/{name}"] = g.gather(v)


def _scans(g, out: dict) -> None:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.vector.distributed import (sharded_cea_scan,
                                                sharded_cer_pipeline)
    s = {k: torch.from_numpy(v) for k, v in scan_inputs().items()
         if k != "specs"}
    W = 8 * ((SCAN_EPS + 1 + 7) // 8)
    S = s["m_all"].shape[1]
    c0 = torch.zeros((8, W, S))
    m, c = sharded_cea_scan(g, g.block(s["ids"], 1), s["m_all"],
                            s["finals"], g.block(c0), epsilon=SCAN_EPS)
    out["scan/matches"], out["scan/ring"] = g.gather(m, 1), g.gather(c)
    ind = ops.class_indicator(s["class_of"].numpy(), s["m_all"].shape[0])
    m, c = sharded_cer_pipeline(
        g, g.block(s["attrs"], 1), _specs(scan_inputs()["specs"]),
        s["class_of"], ind, s["m_all"], s["finals"][None, :], g.block(c0),
        init_mask=s["init_mask"], epsilon=PIPE_EPS, start_pos=PIPE_START)
    out["pipe/matches"], out["pipe/ring"] = g.gather(m, 1), g.gather(c)


def _restore(g, ckpt_dir: str, out: dict) -> None:
    """The world-1 checkpoint of ``ckpt_dir`` onto this group: lane-indexed
    leaves as this rank's block, ``w`` whole."""
    import torch

    from repro_torch.checkpoint import (CheckpointManager, LaneShard,
                                        restore_resharded)
    mgr = CheckpointManager(ckpt_dir)
    arrays, _ = mgr.load_arrays()
    template = {"state": {"C": arrays["state/C"],
                          "lane_keys": arrays["state/lane_keys"]},
                "w": arrays["w"]}
    shard = LaneShard(g, 0)
    placed, extra = restore_resharded(
        mgr, template, {"state": {"C": shard, "lane_keys": shard},
                        "w": torch.device("cpu")})
    out["restore/C"] = placed["state"]["C"]
    out["restore/lane_keys"] = placed["state"]["lane_keys"]
    out["restore/w"] = placed["w"]
    out["restore/extra_step"] = torch.tensor(extra["step"])


def _np(v) -> np.ndarray:
    import torch
    if v.dtype == torch.uint32:
        return v.view(torch.int32).numpy().view(np.uint32)
    return v.numpy()


def rank_main(rank: int, world: int, work: str, ckpt_dir: str = "") -> None:
    """One rank: route, scans and (given ``ckpt_dir``) the resharded
    restore on a gloo group through ``work/store``, then (given
    ``ckpt_dir``) the dry run on a second group, with ``RANK`` and
    ``WORLD_SIZE`` set as ``torchrun`` sets them."""
    try:
        from repro_torch.launch.mesh import init_stream_group
        out = {}
        g = init_stream_group(os.path.join(work, "store"), rank=rank,
                              world_size=world, backend="gloo",
                              device="cpu", timeout=TIMEOUT)
        try:
            _route(g, out)
            _scans(g, out)
            if ckpt_dir:
                _restore(g, ckpt_dir, out)
        finally:
            g.close()
        res = {k: _np(v) for k, v in out.items()}
        if ckpt_dir:
            from repro_torch.launch import cer_dryrun
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                              LOCAL_RANK=str(rank))
            dry = cer_dryrun.main(["--device", "cpu", "--streams", "64",
                                   "--chunk", "32", "--store",
                                   os.path.join(work, "dry_store")])
            res.update({f"dry/{k}": np.asarray(v) for k, v in dry.items()
                        if k != "device"})
        np.savez(os.path.join(work, f"rank{rank}.npz"), **res)
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# the MoE mesh paths (tests/test_torch_moe_mesh.py)
# ---------------------------------------------------------------------------

MOE_ARCHS = ("granite_moe_1b", "deepseek_v3_671b")
MOE_SHAPES = ((4, 1), (4, 8), (4, 256))      # 4, 32 and 1024 tokens
MOE_MESH = {"data": 2, "model": 2}


def moe_cfg(cfg):
    """A smoke config at the published capacity factor, 1.25."""
    import dataclasses
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))


def moe_x(cfg, B: int, S: int, router_w: np.ndarray) -> np.ndarray:
    """Tokens (B, S, d_model) from a seed, pushed along the router's
    first two experts' columns so that their capacity binds at 1024."""
    rng = np.random.default_rng(B * S + cfg.d_model)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    lean = router_w[:, 0] + router_w[:, 1]
    lean = lean / np.linalg.norm(lean)
    return (x + 3.0 * lean).astype(np.float32)


def moe_rank_main(rank: int, world: int, work: str) -> None:
    """One rank of a 2 × 2 ``("data", "model")`` mesh on gloo: for each
    arch and shape of ``work/moe_inputs.npz``, its batch block through
    ``moe_apply`` under the mesh; ``y``, ``aux`` and the path taken to
    ``moe_rank<r>.npz``."""
    try:
        import torch
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch.mesh import (init_model_mesh,
                                             init_stream_group,
                                             use_model_mesh)
        from repro_torch.models import moe
        inputs = dict(np.load(os.path.join(work, "moe_inputs.npz")))
        g = init_stream_group(os.path.join(work, "moe_store"), rank=rank,
                              world_size=world, backend="gloo",
                              device="cpu", timeout=TIMEOUT)
        out = {}
        try:
            mesh = init_model_mesh(MOE_MESH, rank)
            d = mesh.axis_index("data")
            for arch in MOE_ARCHS:
                cfg = moe_cfg(get_smoke_config(arch))
                p = {}
                for key, v in inputs.items():
                    parts = key.split("/")
                    if parts[0] == arch and parts[1] == "p":
                        node = p
                        for part in parts[2:-1]:
                            node = node.setdefault(part, {})
                        node[parts[-1]] = torch.from_numpy(v)
                for B, S in MOE_SHAPES:
                    x = torch.from_numpy(inputs[f"{arch}/x/{B}x{S}"])
                    b = B // mesh.axis_size("data")
                    with use_model_mesh(mesh):
                        y, aux = moe.moe_apply(p, cfg, x[d * b:(d + 1) * b])
                    out[f"{arch}/{B}x{S}/y"] = y.numpy()
                    out[f"{arch}/{B}x{S}/aux"] = np.float32(aux)
                    out[f"{arch}/{B}x{S}/path"] = np.array(
                        moe.moe_path(cfg, b, S, mesh)[0])
        finally:
            g.close()
        np.savez(os.path.join(work, f"moe_rank{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(work, f"moe_rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
