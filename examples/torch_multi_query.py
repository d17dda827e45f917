"""Multi-query CER on the PyTorch port: q CEQL queries over the same
streams in ONE packed scan.

Production CER deployments run many standing queries per stream; the
packed block-diagonal scan (vector/multiquery.py) evaluates them together.

    PYTHONPATH=src python examples/torch_multi_query.py [--device cpu]

The engine runs on the CUDA device (the fused-scan kernel) unless
``--device cpu`` asks for the plain PyTorch version.  It prints what
``examples/multi_query.py`` prints for the same streams.
"""
import argparse

from repro_torch.data.streams import stock_stream
from repro_torch.vector.multiquery import MultiQueryEngine

QUERIES = {
    "msft_spike": ("SELECT * FROM S WHERE SELL AS a ; SELL AS b "
                   "FILTER a[name = 'MSFT'] AND a[price > 45.0] "
                   "AND b[name = 'MSFT'] AND b[price > 45.0]"),
    "orcl_dip": ("SELECT * FROM S WHERE BUY AS a ; BUY AS b "
                 "FILTER a[name = 'ORCL'] AND a[price < 8.0] "
                 "AND b[name = 'ORCL'] AND b[price < 8.0]"),
    "cross_trade": ("SELECT * FROM S WHERE SELL AS a ; BUY AS b ; SELL AS c "
                    "FILTER a[name = 'MSFT'] AND b[name = 'ORCL'] "
                    "AND c[name = 'AMZN']"),
    "churn": "SELECT * FROM S WHERE BUY ; SELL ; BUY ; SELL",
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu for the plain PyTorch version; default the "
                         "CUDA device")
    device = ap.parse_args(argv).device
    streams = [stock_stream(4096, seed=s) for s in range(8)]
    eng = MultiQueryEngine(list(QUERIES.values()), epsilon=60, device=device)
    print(f"packed {len(QUERIES)} queries into Ŝ={eng.packed_states} states, "
          f"{eng.tables.m_all.shape[0]} joint symbol classes, "
          f"{eng.symbolics[0].num_bits} shared predicate bits")
    counts, _ = eng.run(streams)
    for qi, name in enumerate(QUERIES):
        c = counts[:, :, qi]
        print(f"  {name:12s}: {int(c.sum()):7d} matches "
              f"across {int((c > 0).sum())} (pos, stream) hits")
    return {"counts": counts}


if __name__ == "__main__":
    main()
