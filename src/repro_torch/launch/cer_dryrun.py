"""Distributed CER dry run of the port: the sharded engine's two pieces on
every rank.

* ``sharded_cea_scan`` — this rank's block of the B partitions through one
  chunk of the windowed counting scan, with no collective;
* ``route_by_partition`` — the one collective: one chunk of events
  ``all_to_all``-routed to the rank owning their partition hash.

Each rank prints the bytes its scan state and operands hold and the bytes
its ``all_to_all`` sends and receives per chunk: the counterparts of the
reference dry run's ``memory_analysis()`` and collective bytes, which it
reads from XLA's compile for 512 fake TPU devices.  Here the pieces run
for real, so no XLA flag and no fake device is needed::

    python -m repro_torch.launch.cer_dryrun [--streams 8192] [--chunk 512]
        [--epsilon 95] [--device cpu] [--store PATH]
    python -m torch.distributed.run --nproc-per-node N \\
        -m repro_torch.launch.cer_dryrun

It runs on the CUDA device (``cuda:LOCAL_RANK``, NCCL) unless ``--device
cpu`` asks for the CPU (gloo), and raises without a card.  Under
``torchrun`` every rank joins the file store at ``--store``; by default a
path in the temporary directory named after the run's id and port.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import List, Optional

import numpy as np
import torch

from ..core.query import compile_query
from ..kernels.window import DeviceWindow
from ..vector.distributed import route_by_partition, sharded_cea_scan
from ..vector.symbolic import compile_symbolic
from .mesh import make_production_mesh

QUERY = ("SELECT * FROM S WHERE SELL AS a ; BUY AS b ; SELL AS c "
         "FILTER a[price > 25.0] AND c[price < 10.0]")
ROUTER_COLUMNS = 4


def default_store() -> Optional[str]:
    """The store every rank of a ``torchrun`` job names alike; None
    outside one (a fresh temporary directory is used)."""
    env = os.environ
    if "TORCHELASTIC_RUN_ID" not in env:
        return None
    return os.path.join(tempfile.gettempdir(),
                        f"repro_torch_cer_dryrun_{env['TORCHELASTIC_RUN_ID']}"
                        f"_{env.get('MASTER_PORT', '0')}")


def run(group, streams: int, chunk: int, epsilon: int, seed: int = 0
        ) -> dict:
    """One chunk of each piece on this rank's block; returns the numbers
    it prints."""
    n, r, dev = group.world_size, group.rank, group.device
    if streams % n:
        raise ValueError(f"--streams {streams} does not split over {n} "
                         "ranks")
    sym = compile_symbolic(compile_query(QUERY).cea)
    S, C = sym.num_states, sym.num_classes
    W = DeviceWindow.events(epsilon).ring
    B, T = streams // n, chunk
    gen = torch.Generator().manual_seed(seed + r)
    ids = torch.randint(0, C, (T, B), generator=gen,
                        dtype=torch.int32).to(dev)
    m_all = torch.from_numpy(sym.transition_matrices()).to(dev)
    finals = torch.from_numpy(sym.finals.astype(np.float32)).to(dev)
    c0 = torch.zeros((B, W, S), dtype=torch.float32, device=dev)
    matches, c_fin = sharded_cea_scan(group, ids, m_all, finals, c0,
                                      epsilon=epsilon)
    if not bool(torch.isfinite(matches).all()):
        raise RuntimeError("the sharded scan returned non-finite counts")
    operand_bytes = 4 * (ids.numel() + m_all.numel() + finals.numel()
                         + c0.numel())
    out_bytes = 4 * (matches.numel() + c_fin.numel())
    # the router: each rank needs one slot per destination at least, so a
    # block holds n·4 events (the reference's n_dev² × 4 in all)
    N = n * 4
    events = torch.randn((N, ROUTER_COLUMNS), generator=gen).to(dev)
    keys = torch.randint(0, 1 << 30, (N,), generator=gen,
                         dtype=torch.int32).to(dev)
    routed, keep = route_by_partition(group, events, keys)
    sent = routed.numel() * 4
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"rank": r, "world": n, "device": str(dev), "B_local": B, "T": T,
            "S": S, "W": W, "state_bytes": c0.numel() * 4,
            "operand_bytes": operand_bytes, "output_bytes": out_bytes,
            "matches": int(matches.sum().item()),
            "all_to_all_bytes_sent": sent, "all_to_all_bytes_received": sent,
            "router_rows": N, "router_kept": int(keep.sum().item())}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--streams", type=int, default=8192)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--epsilon", type=int, default=95)
    ap.add_argument("--device", default=None,
                    help="cpu for the CPU (gloo); default the CUDA device")
    ap.add_argument("--store", default=None,
                    help="file store of the group (a path that does not "
                         "exist yet, the same on every rank)")
    args = ap.parse_args(argv)
    store, scratch = args.store or default_store(), None
    if store is None:
        scratch = tempfile.mkdtemp(prefix="repro_torch_cer_dryrun_")
        store = os.path.join(scratch, "store")
    try:
        group = make_production_mesh(store, device=args.device)
        try:
            res = run(group, args.streams, args.chunk, args.epsilon)
        finally:
            group.close()
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)
    tag = f"[cer-dryrun rank {res['rank']}/{res['world']}]"
    print(f"{tag} scan ran on {res['device']} (B={res['B_local']} of "
          f"{args.streams} partitions, T={res['T']}, S={res['S']}, "
          f"W={res['W']}): state {res['state_bytes']} bytes, operands "
          f"{res['operand_bytes']}, outputs {res['output_bytes']}; "
          f"collectives: none", flush=True)
    print(f"{tag} router: all_to_all {res['all_to_all_bytes_sent']} bytes "
          f"sent and {res['all_to_all_bytes_received']} received per chunk "
          f"({res['router_rows']} events, {res['router_kept']} kept)",
          flush=True)
    return res


if __name__ == "__main__":
    main()
