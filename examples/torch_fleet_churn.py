"""Dynamic query fleet demo of the PyTorch port: hot add/remove queries over
a live stream.

    PYTHONPATH=src python examples/torch_fleet_churn.py [--device cpu]

The fleet runs on the CUDA device (the fused-scan kernel for counting, the
arena-store kernel for the tECS arena) unless ``--device cpu`` asks for the
plain PyTorch versions.  One deterministic attribute stream flows while the
query set changes under it: two queries start, a third (with a different
WITHIN window) hot-joins mid-stream, one is removed, then re-added.  Every
transition is a repack: the surviving queries keep their in-flight partial
runs (the demo asserts each query's counts equal a freshly built engine's
fed the same events from the query's add position), while the step cache
keeps one entry per distinct bucket geometry.  Per-query cost reports
(states, hits, matches, live tECS arena nodes) print after each phase.

Exit is nonzero if any parity assertion fails.
"""
import argparse

import numpy as np

T, B = 32, 2

SPIKE = ("SELECT * FROM S WHERE (E AS a; E AS b) "
         "FILTER a[x > 7] AND b[x < 2] WITHIN 16 events")
RALLY = ("SELECT * FROM S WHERE (E AS a; E AS b) "
         "FILTER a[y > 6] AND b[y > 6] WITHIN 16 events")
BURST = ("SELECT * FROM S WHERE (E AS a; E AS b; E AS c) "
         "FILTER a[x > 5] AND b[y > 5] AND c[x < 5] WITHIN 8 events")


def mk_chunks(n):
    from repro_torch.core.events import Event
    rng = np.random.default_rng(42)
    return [[[Event("E", {"x": float(rng.integers(0, 10)),
                          "y": float(rng.integers(0, 10))})
              for _ in range(T)] for _ in range(B)]
            for _ in range(n)]


def oracle_counts(query, chunks, device):
    """A freshly built static engine fed ``chunks`` from empty state."""
    from repro_torch.vector import MultiQueryEngine, StreamingVectorEngine
    se = StreamingVectorEngine(MultiQueryEngine([query], device=device), T,
                               B)
    return [se.feed(c)[0][:, :, 0] for c in chunks]


def print_report(fleet, phase):
    print(f"\n[{phase}] pos={fleet.position} buckets={fleet.num_buckets} "
          f"compiles={fleet.compile_count} "
          f"(distinct geometries={fleet.distinct_geometries}, "
          f"cache hits={fleet.cache_hits})")
    for qid, r in sorted(fleet.cost_report().items()):
        print(f"  {qid}: states={r['states']} slot={r['slot']} "
              f"bucket={r['bucket'][0]}/{r['bucket'][1]:g} "
              f"hits={r['hits']} matches={r['matches']} "
              f"arena_nodes={r['arena_nodes']}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    device = parser.parse_args().device
    from repro_torch.runtime import QueryFleet
    chunks = mk_chunks(8)
    fleet = QueryFleet(chunk_len=T, batch=B, arena_capacity=1 << 12,
                       device=device)
    results = {}                 # qid -> (add position chunk idx, [counts])

    def feed(i):
        counts, _ = fleet.feed(chunks[i])
        for qid in fleet.live_qids:
            results.setdefault(qid, (i, []))[1].append(
                counts[:, :, fleet.live_qids.index(qid)])

    fleet.add_query(SPIKE, qid="spike")
    fleet.add_query(RALLY, qid="rally")
    feed(0)
    feed(1)
    print_report(fleet, "2 queries, 1 bucket")

    fleet.add_query(BURST, qid="burst")       # different window: new bucket
    feed(2)
    feed(3)
    print_report(fleet, "hot-added 'burst' (8-event bucket)")

    # enumerate one hit of the hottest query straight from the device arena
    rep = fleet.cost_report()
    hot = max(rep, key=lambda q: rep[q]["matches"])
    added, got = results[hot]
    pos = np.argwhere(np.stack(got) > 0)
    if pos.size:
        ci, t, b = pos[-1][:3]
        p = int((added + ci) * T + t)
        ces = fleet.enumerate(hot, p, int(b))
        print(f"\n  '{hot}' hit at position {p} stream {int(b)}: "
              f"{len(ces)} complex event(s), e.g. {ces[0].data}")

    fleet.remove_query("rally")               # repack; spike's runs survive
    feed(4)
    feed(5)
    print_report(fleet, "removed 'rally' mid-stream")

    fleet.add_query(RALLY, qid="rally2")      # re-add: a cache hit
    feed(6)
    feed(7)
    print_report(fleet, "re-added as 'rally2' (step-cache hit)")

    # parity: every query's counts == a fresh engine fed its post-add suffix
    texts = {"spike": SPIKE, "rally": RALLY, "burst": BURST, "rally2": RALLY}
    for qid, (added, got) in results.items():
        want = oracle_counts(texts[qid], chunks[added:added + len(got)],
                             fleet.device)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert fleet.compile_count <= fleet.distinct_geometries
    print(f"\nfleet churn OK on {fleet.device}: {len(results)} query "
          f"lifetimes bit-identical to fresh engines; {fleet.compile_count} "
          f"step-cache entries run for {fleet.distinct_geometries} distinct "
          f"geometries over {fleet.cache_hits + fleet.distinct_geometries} "
          "engine builds")


if __name__ == "__main__":
    main()
