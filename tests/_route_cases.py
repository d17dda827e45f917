"""Lane tables and key streams for the lane router's tests, shared by the
CPU tests against the reference package and the card tests against the
plain router.  Imports neither JAX nor the reference package."""
import numpy as np

from repro_torch.core.partition import EMPTY_LANE, NULL_KEY_HASH

ROUTE_T = 24
ROUTE_POOL = [3, 11, 0x80000001, 0xFFFFFFFD, 5, 42, 17, 0x7FFFFFFF]


def route_cases(rng, L):
    """Key streams and lane tables: random mixes, an all-NULL chunk, a
    full table of absent keys, lane_last ties, raw EMPTY_LANE keys."""
    sentinels = [NULL_KEY_HASH, EMPTY_LANE]
    for trial in range(7):
        pool = ROUTE_POOL[:max(2, L + trial % 4)]
        if trial == 0:       # all NULL (and raw EMPTY_LANE)
            keys = [sentinels[i % 2] for i in range(ROUTE_T)]
        else:
            keys = [rng.choice(pool + sentinels[:trial % 3])
                    for _ in range(ROUTE_T)]
        if trial == 1:       # every lane owned, by keys absent from the chunk
            table = [1000 + b for b in range(L)]
        elif trial == 2:     # empty table
            table = [EMPTY_LANE] * L
        else:
            table = [rng.choice(pool + [EMPTY_LANE, EMPTY_LANE, 999])
                     for _ in range(L)]
        last = [rng.choice([-1, 0, 1, 1, 2]) for _ in range(L)]  # ties
        yield keys, table, last, 2 + trial


def dup_tables(rng, L, T, trials=6):
    """(keys, lane_keys, lane_last, chunk_idx) as int64/int64/int32 arrays:
    tables that hold keys in several lanes (ties in lane_last; empty lanes
    in every other trial), chunks that open with new keys, so that LRU
    evicts a key's lowest lane before the key comes, then the table's
    keys, new keys, NULL and raw EMPTY_LANE keys mixed."""
    pool = rng.choice(EMPTY_LANE - 1, size=max(2, L // 3 + 1), replace=False)
    for trial in range(trials):
        table = rng.choice(pool, L)
        if trial % 2:
            table[rng.random(L) < 0.2] = EMPTY_LANE
        last = rng.integers(-1, 3, L)
        n_new = min(T, int(rng.integers(1, L // 2 + 2)))
        fresh = rng.choice(EMPTY_LANE - 1, size=T)
        r = rng.random(T - n_new)
        tail = np.where(r < 0.7, rng.choice(pool, T - n_new), fresh[n_new:])
        tail[r > 0.95] = NULL_KEY_HASH
        tail[r > 0.98] = EMPTY_LANE
        yield (np.concatenate([fresh[:n_new], tail]).astype(np.int64),
               table.astype(np.int64), last.astype(np.int32), 3 + trial)


def later_holders(keys, table, lanes) -> int:
    """Events routed to a lane that held their key before the chunk, other
    than the lowest such lane (whose key an eviction took earlier)."""
    table = [int(k) for k in table]
    L, first = len(table), {}
    for lane, k in enumerate(table):
        first.setdefault(k, lane)
    return sum(1 for k, lane in zip(keys.tolist(), lanes.tolist())
               if lane < L and table[lane] == k and first[k] != lane)
