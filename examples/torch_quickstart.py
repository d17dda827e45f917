"""Quickstart on the PyTorch port: compile a CEQL query, run it over a
stream, enumerate matches.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The device engines run on the CUDA device (the fused-scan kernel) unless
``--device cpu`` asks for the plain PyTorch versions.  It prints what
``examples/quickstart.py`` prints for the same streams.
"""
import argparse

from repro_torch.core import compile_query
from repro_torch.data.streams import stock_stream
from repro_torch.vector import VectorEngine

QUERY = """
SELECT * FROM Stock
WHERE SELL AS msft ; (BUY OR SELL) AS orcl ; SELL AS amzn
FILTER msft[name = 'MSFT'] AND msft[price > 26.0]
  AND orcl[name = 'ORCL']
  AND amzn[name = 'AMZN'] AND amzn[price >= 18.97]
WITHIN 30000 [stock_time]
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu for the plain PyTorch versions; default the "
                         "CUDA device")
    device = ap.parse_args(argv).device
    # ------------------------------------------------------------------
    # host engine: constant update time, output-linear enumeration
    # ------------------------------------------------------------------
    stream = stock_stream(50_000, seed=42)
    q = compile_query(QUERY)
    print(f"query compiled: {q.cea.num_states} CEA states, "
          f"{q.cea.registry.num_bits} atomic predicates")
    shown = 0
    total = 0
    for pos, match in q.run(iter(stream), max_enumerate=10):
        total += 1
        if shown < 5:
            print(f"  match at {pos}: interval={match.time} "
                  f"events={match.data}")
            shown += 1
    print(f"host engine: {total} complex events (first 10 per position)")

    # ------------------------------------------------------------------
    # device engine: same query, batched streams, counting on the card
    # ------------------------------------------------------------------
    qtext = ("SELECT * FROM S WHERE SELL AS a ; BUY AS b "
             "FILTER a[price > 25.0] AND b[price < 10.0] "
             "WITHIN 100 events")
    streams = [stock_stream(4096, seed=s) for s in range(8)]
    ve = VectorEngine(qtext, device=device)   # WITHIN drives the ring
    counts, _ = ve.run(streams)
    print(f"device engine: {int(counts.sum())} matches across "
          f"{len(streams)} parallel streams "
          f"(det states={ve.tables.num_states}, "
          f"classes={ve.tables.num_classes})")
    print(f"hit positions (first 5): {ve.hit_positions(counts)[:5]}")

    # ------------------------------------------------------------------
    # time windows on both engines (DESIGN.md §9): WITHIN 30 seconds over
    # a timestamped stream — the device evicts by timestamp mask, with
    # max_window_events bounding the simultaneously-live starts
    # ------------------------------------------------------------------
    qtime = ("SELECT * FROM S WHERE SELL AS a ; BUY AS b "
             "FILTER a[price > 25.0] AND b[price < 10.0] "
             "WITHIN 30 seconds")
    tstream = stock_stream(2048, seed=7, events_per_sec=4.0)  # 0.25 s ticks
    host_total = sum(1 for _ in compile_query(qtime).run(iter(tstream)))
    vt = VectorEngine(qtime, max_window_events=256, device=device)
    tcounts, tstate = vt.run([tstream])
    if int(tcounts.sum()) != host_total or vt.window_overflow(tstate).any():
        raise SystemExit(f"time window: device {int(tcounts.sum())} "
                         f"matches, host {host_total}, overflow "
                         f"{vt.window_overflow(tstate).tolist()}")
    print(f"time window (30 s): host and device agree on "
          f"{host_total} matches over {len(tstream)} timestamped events")
    return {"host_total": total, "counts": counts, "tcounts": tcounts}


if __name__ == "__main__":
    main()
