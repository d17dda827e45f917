#!/usr/bin/env python3
"""The control of a cell's comparison on the card: a run of the cell at
its own size with ``entries/control.py`` (the reference in the precision
below the configuration's) in the program's place.

    python3 bench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Each seed is one run of ``run.py``'s ``run_cell``, judged by the same
comparison as the program's runs; one JSON line a seed gives the numbers
compared and whether the run came out correct, which it must not.  The
benchmark's own runs never run it.
"""
import argparse
import json
import sys
from pathlib import Path

_root = Path(__file__).resolve().parents[1]
for _p in (str(_root), str(_root / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    spec = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        res = bench_run.run_cell(args.workload, seed, args.seconds, False,
                                 spec=spec, device=device, entry="control")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": device, "attempted": res["attempted"],
                          "checks": {k: c["value"]
                                     for k, c in res["checks"].items()},
                          "correct": res["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
