"""Cost extrapolation from small variants (a second pass over the dry
run's records), the reference's ``launch/costmodel.py`` on PyTorch.

The reference needs this pass because XLA's ``cost_analysis()`` counts a
while-loop body once, so a scan over layers undercounts.  The port's dry
run dispatches every op of every layer and counts each, so its direct
count at full depth already holds every layer; the extrapolation is kept
as the reference's cross-check, and the two must agree:

1. For each cell, small variants of the config (1-3 layers, one per
   distinct layer type plus a base, so the (base, per-layer-type) system
   is square; ``scan_layers=False`` as in the reference).
2. Each variant runs as a dry-run cell on the same mesh and shape (flops,
   bytes, collective bytes per kind).
3. Solve F(variant) = base + Σ_t count_t(variant) · per_layer_t and
   extrapolate to the real layer counts.
4. Write ``x_flops / x_bytes / x_collectives`` into the dry-run record.

Usage::

    python -m repro_torch.launch.costmodel --all [--mesh pod16x16]
    python -m repro_torch.launch.costmodel --arch qwen3-32b --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from ..configs import ALIASES, get_config
from ..models.config import ModelConfig

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def type_counts(cfg: ModelConfig) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for i, kind in enumerate(cfg.layer_kinds()):
        t = f"{kind}{'_moe' if cfg.layer_is_moe(i) else ''}"
        counts[t] = counts.get(t, 0) + 1
    if cfg.encoder_layers:
        counts["encoder"] = cfg.encoder_layers
    return counts


def variants(cfg: ModelConfig) -> List[Tuple[ModelConfig, Dict[str, int]]]:
    """Small unrolled variants spanning the (base, per-type) system."""
    def mk(**kw) -> ModelConfig:
        return dataclasses.replace(cfg, scan_layers=False, **kw)

    out: List[ModelConfig] = []
    if cfg.shared_attn_every:                       # zamba2 family
        out = [mk(num_layers=2, shared_attn_every=2),
               mk(num_layers=3, shared_attn_every=3),
               mk(num_layers=4, shared_attn_every=2)]
    elif cfg.moe is not None and cfg.first_dense_layers > 0:   # dsv3
        out = [mk(num_layers=2, first_dense_layers=1),
               mk(num_layers=3, first_dense_layers=2),
               mk(num_layers=3, first_dense_layers=1)]
    elif cfg.encoder_layers:                        # whisper
        out = [mk(num_layers=1, encoder_layers=1),
               mk(num_layers=2, encoder_layers=1),
               mk(num_layers=1, encoder_layers=2)]
    else:                                           # uniform stack
        out = [mk(num_layers=1), mk(num_layers=2)]
    return [(v, type_counts(v)) for v in out]


def cell_costs(cfg: ModelConfig, arch: str, shape_name: str, mesh,
               mesh_name: str) -> Dict[str, float]:
    """flops, bytes and collective bytes per kind of one dry-run cell of
    ``cfg`` (a record not written)."""
    from .dryrun import run_cell
    rec = run_cell(arch, shape_name, mesh, mesh_name, save=False,
                   verbose=False, cfg=cfg)
    out = {"flops": rec["flops"], "bytes": rec["bytes_accessed"]}
    for k in _COLL_KINDS:
        out[f"coll_{k}"] = float(rec["collectives"].get(k, 0.0))
    return out


def _solve(A, rows, metric, types, real) -> float:
    """Fit base + per-layer-type costs to the variants and evaluate at the
    real counts.  Unlike the reference's, no term is clamped at zero: the
    port's counts are exact, and a negative base is real (a cost paid
    between consecutive layers, which a stack of n layers pays n - 1
    times, is fitted as a per-layer cost and a negative base)."""
    y = np.asarray([r[metric] for r in rows])
    sol, *_ = np.linalg.lstsq(np.asarray(A), y, rcond=None)
    base, per = sol[0], dict(zip(types, sol[1:]))
    return float(base + sum(per[t] * real.get(t, 0) for t in types))


def extrapolate(arch: str, shape_name: str, mesh, mesh_name: str,
                cfg: ModelConfig = None) -> Dict[str, float]:
    """Per-device flops, bytes and collective bytes of ``cfg`` (by default
    the arch's published config) extrapolated from its variants."""
    cfg = cfg or get_config(arch)
    vs = variants(cfg)
    types = sorted({t for _, c in vs for t in c})
    real = type_counts(cfg)
    A, rows = [], []
    for vcfg, counts in vs:
        A.append([1.0] + [float(counts.get(t, 0)) for t in types])
        rows.append(cell_costs(vcfg, arch, shape_name, mesh, mesh_name))
    out: Dict[str, float] = {}
    out["flops"] = _solve(A, rows, "flops", types, real)
    out["bytes"] = _solve(A, rows, "bytes", types, real)
    for k in _COLL_KINDS:
        out[f"coll_{k}"] = _solve(A, rows, f"coll_{k}", types, real)
    return out


def apply_to_record(path: str, mesh_cache: Dict) -> None:
    from .dryrun import production_mesh

    with open(path) as f:
        rec = json.load(f)
    mesh_name = rec["mesh"]
    if mesh_name not in mesh_cache:
        mesh_cache.clear()            # one fake group at a time
        mesh_cache[mesh_name] = production_mesh(mesh_name)
    x = extrapolate(rec["arch"], rec["shape"], mesh_cache[mesh_name],
                    mesh_name)
    rec["x_flops"] = x["flops"]
    rec["x_bytes"] = x["bytes"]
    rec["x_collectives"] = {k: x[f"coll_{k}"] for k in _COLL_KINDS}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[costmodel] {rec['arch']} × {rec['shape']} × {mesh_name}: "
          f"x_flops={x['flops']:.3e} (direct {rec['flops']:.3e}) "
          f"x_bytes={x['bytes']:.3e}")


def main(argv=None) -> None:
    from .dryrun import RESULTS_DIR

    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod16x16",
                    help="only extrapolate records for this mesh; 'all' "
                         "for both")
    ap.add_argument("--keep-going", action="store_true")
    args = ap.parse_args(argv)

    paths = sorted(glob.glob(os.path.join(RESULTS_DIR, "*.json")))
    if args.arch:
        arch = ALIASES.get(args.arch, args.arch)
        paths = [p for p in paths if os.path.basename(p).startswith(arch)]
    if args.shape:
        paths = [p for p in paths if f"__{args.shape}__" in p]
    if args.mesh != "all":
        paths = [p for p in paths if p.endswith(f"__{args.mesh}.json")]
    # records of one mesh together: one fake group at a time
    paths.sort(key=lambda p: p.rsplit("__", 1)[-1])

    mesh_cache: Dict = {}
    failures = []
    for p in paths:
        try:
            apply_to_record(p, mesh_cache)
        except Exception as e:
            failures.append((p, repr(e)))
            print(f"[costmodel] FAIL {p}: {e}")
            if not args.keep_going:
                raise
    if failures:
        raise SystemExit(f"{len(failures)} failures")


if __name__ == "__main__":
    main()
