"""Plain reference of sequence queries ``X ; Y ; Z WITHIN eps events``
under ALL semantics, in closed form.

A run starts at an ``X`` event ``s``, takes any later ``Y`` event and ends
at a ``Z`` event ``j`` with ``j - s <= eps`` (positions count the events of
the run's own substream: a lane, or one key's events).  The count at ``j``
is the number of such ``(s, y)`` pairs:

    count(j) = [Z at j] * sum over X at s in [j - eps, j) of #Y in (s, j)

which prefix sums give for every position at once.  What a run has taken
so far is a state of the sequence's counting automaton, one per step of
progress: nothing taken, X taken at this event, X taken earlier, Y taken
at this event, Y taken earlier, Z taken at this event (a match), and the
empty set.  The ring holds, for each live start ``s`` (``J - eps <= s <=
J`` at the last event ``J``, in slot ``s mod W``), how many runs from
``s`` sit in each of those seven states: order aside, the vector of a
slot is the same whatever numbering the program gives its states, so the
judge compares each slot's values sorted.

Nothing here comes from the program: the inputs are the traffic's type
and key draws, and the program's outputs are read only to be judged.
"""
import numpy as np
import torch

#: states a query's counting automaton holds in each ring slot
STATES = 7


def query_types(seq: str, type_names) -> tuple:
    """``"A1 ; A2 ; A3"`` → the type indices of X, Y and Z; a type the
    traffic never draws gets an index no event has."""
    names = [t.strip() for t in seq.split(";")]
    if len(names) != 3:
        raise ValueError(f"not a three-event sequence: {seq!r}")
    return tuple(type_names.index(n) if n in type_names else len(type_names)
                 for n in names)


def _prefix(v: torch.Tensor) -> torch.Tensor:
    """``p[i] = v[0] + ... + v[i-1]``, ``p[0] = 0``, in ``v``'s dtype."""
    return torch.cat([v.new_zeros(1), torch.cumsum(v, 0, dtype=v.dtype)])


def counts_flat(types: torch.Tensor, lo: torch.Tensor, xyz,
                dtype=torch.int64) -> torch.Tensor:
    """Counts at every index of ``types`` (N,), a concatenation of
    substreams each in stream order; ``lo[j]`` is the first index of
    ``j``'s window (never before ``j``'s substream).  Computed in
    ``dtype``; returns int64."""
    x, y, z = ((types == t).to(dtype) for t in xyz)
    py = _prefix(y)
    g1 = _prefix(x)
    g2 = _prefix(x * py[1:])
    j = torch.arange(types.shape[0], device=types.device)
    out = z * ((g1[j] - g1[lo]) * py[j] - (g2[j] - g2[lo]))
    return out.round().to(torch.int64) if dtype.is_floating_point \
        else out.to(torch.int64)


def ring_rows(types: torch.Tensor, last: torch.Tensor, live: torch.Tensor,
              xyz, dtype=torch.int64) -> torch.Tensor:
    """The seven state counts of the runs started at each index ``s`` of
    ``types`` (N,) once its substream's last event ``last[s]`` has been
    read; rows where ``live`` is false are zero.  Returns (N, 7) int64."""
    x, y, z = ((types == t).to(dtype) for t in xyz)
    py = _prefix(y)
    s = torch.arange(types.shape[0], device=types.device)
    xs = x * live.to(dtype)
    now = (s == last).to(dtype)
    y_between = py[last] - py[s + 1]          # Y in (s, last)
    zero = torch.zeros_like(xs)
    rows = torch.stack([zero, zero,
                        xs * now,                       # X at this event
                        xs * (1 - now),                 # X earlier
                        xs * (1 - now) * y[last],       # Y at this event
                        xs * y_between,                 # Y earlier
                        xs * z[last] * y_between], 1)   # Z: a match
    return rows.round().to(torch.int64) if dtype.is_floating_point \
        else rows.to(torch.int64)


# ---------------------------------------------------------------------------
# pre-partitioned lanes
# ---------------------------------------------------------------------------


def _lane_block(traffic, k: int, window: int):
    """Types of feeds ``[k0, k]`` lane by lane, flat, with the first index
    of each position's window: ``(types (B*N,), lo (B*N,), k0, N)``."""
    h = traffic.fill_feeds(window)
    k0 = max(0, k - h)
    block = traffic.lane_types(range(k0, k + 1))          # (N, B)
    N, B = block.shape
    t = torch.arange(N, device=block.device)
    lo = (torch.arange(B, device=block.device)[:, None] * N
          + (t - window).clamp(min=0)[None, :])
    return block.t().reshape(-1), lo.reshape(-1), k0, N


def lane_counts(traffic, cfg, k: int, dtype=torch.int64) -> torch.Tensor:
    """(chunk, lanes, Q) counts of feed ``k``."""
    types, lo, _, N = _lane_block(traffic, k, cfg["window"])
    T, B = traffic.chunk, traffic.lanes
    out = [counts_flat(types, lo, query_types(q, traffic.type_names),
                       dtype).reshape(B, N)[:, N - T:].t()
           for q in cfg["queries"]]
    return torch.stack(out, -1)


def lane_ring(traffic, cfg, n_fed: int, W: int, dtype=torch.int64):
    """(lanes, W, 7 Q) state counts of every ring slot after ``n_fed``
    feeds."""
    window = cfg["window"]
    types, _, k0, N = _lane_block(traffic, n_fed - 1, window)
    B = traffic.lanes
    dev = types.device
    i = torch.arange(N, device=dev)
    last = (torch.arange(B, device=dev)[:, None] * N + N - 1).expand(
        B, N).reshape(-1)
    live = (i >= N - 1 - window).repeat(B)
    slot = ((k0 * traffic.chunk + i) % W).repeat(B)
    lane = torch.arange(B, device=dev).repeat_interleave(N)
    Q = len(cfg["queries"])
    ring = torch.zeros((B, W, STATES * Q), dtype=torch.int64, device=dev)
    # live starts have distinct slots in a lane; only they are written
    sel = torch.nonzero(live)[:, 0]
    for q, seq in enumerate(cfg["queries"]):
        rows = ring_rows(types, last, live,
                         query_types(seq, traffic.type_names), dtype)
        ring[lane[sel], slot[sel], STATES * q:STATES * (q + 1)] = rows[sel]
    return ring


# ---------------------------------------------------------------------------
# one interleaved stream, one substream per key
# ---------------------------------------------------------------------------


def _key_block(traffic, k0: int, k1: int):
    """Feeds ``[k0, k1)`` as key substreams: the block's keys and types,
    the sort that groups them by key (stable: stream order within a key)
    and each sorted event's segment start."""
    idx = [traffic.chunk_of(k) for k in range(k0, k1)]
    keys = traffic.keys[idx].reshape(-1).long()
    types = traffic.types[idx].reshape(-1)
    routed = torch.nonzero(keys >= 0)[:, 0]
    order = routed[torch.sort(keys[routed], stable=True)[1]]
    skeys = keys[order]
    n = torch.bincount(skeys, minlength=traffic.n_keys)
    starts = _prefix(n)[:-1]
    return order, skeys, types[order], starts, n


def keyed_counts(traffic, cfg, k: int, dtype=torch.int64) -> torch.Tensor:
    """(chunk, Q) counts at the global positions of feed ``k``."""
    window = cfg["window"]
    k0 = traffic.history(k, window)
    order, skeys, stypes, starts, _ = _key_block(traffic, k0, k + 1)
    i = torch.arange(order.shape[0], device=order.device)
    lo = torch.maximum(starts[skeys], i - window)
    T = traffic.chunk
    out = []
    for seq in cfg["queries"]:
        c = counts_flat(stypes, lo, query_types(seq, traffic.type_names),
                        dtype)
        full = torch.zeros((k + 1 - k0) * T, dtype=torch.int64,
                           device=order.device)
        full[order] = c
        out.append(full[-T:])
    return torch.stack(out, -1)


def keyed_ring(traffic, cfg, n_fed: int, W: int, dtype=torch.int64):
    """(n_keys, W, 7 Q) state counts of every key's ring after ``n_fed``
    feeds; a key's substream position ``p`` sits in slot ``p mod W``."""
    window = cfg["window"]
    k0 = traffic.history(n_fed, window + 1)
    order, skeys, stypes, starts, n = _key_block(traffic, k0, n_fed)
    dev = order.device
    i = torch.arange(order.shape[0], device=dev)
    rank = i - starts[skeys]
    last = (starts + n - 1)[skeys]
    live = rank >= (n[skeys] - 1 - window)
    slot = (traffic.key_events_before(k0)[skeys] + rank) % W
    Q = len(cfg["queries"])
    ring = torch.zeros((traffic.n_keys, W, STATES * Q), dtype=torch.int64,
                       device=dev)
    sel = torch.nonzero(live)[:, 0]
    for q, seq in enumerate(cfg["queries"]):
        rows = ring_rows(stypes, last, live,
                         query_types(seq, traffic.type_names), dtype)
        ring[skeys[sel], slot[sel], STATES * q:STATES * (q + 1)] = rows[sel]
    return ring


# ---------------------------------------------------------------------------
# the judge
# ---------------------------------------------------------------------------


def expected(run, k: int, dtype=torch.int64) -> torch.Tensor:
    """What feed ``k`` should return: lanes (T, B, Q), keyed (T, Q)."""
    if run.traffic.layout == "lanes":
        return lane_counts(run.traffic, run.cfg, k, dtype)
    return keyed_counts(run.traffic, run.cfg, k, dtype)


def expected_ring(run, dtype=torch.int64) -> torch.Tensor:
    """(lanes, W, 7 Q): the state counts each program lane should hold."""
    W = run.ring.shape[1]
    if run.traffic.layout == "lanes":
        return lane_ring(run.traffic, run.cfg, run.n_fed, W, dtype)
    by_key = keyed_ring(run.traffic, run.cfg, run.n_fed, W, dtype)
    table = run.traffic.key_hashes
    srt, perm = torch.sort(table)
    lk = run.lane_keys.to(table.device)
    pos = torch.searchsorted(srt, lk).clamp(max=table.shape[0] - 1)
    held = srt[pos] == lk
    out = torch.zeros((lk.shape[0],) + by_key.shape[1:], dtype=torch.int64,
                      device=by_key.device)
    out[held] = by_key[perm[pos[held]]]
    return out


def hits_of(run, k: int, counts: torch.Tensor) -> np.ndarray:
    """The hit list ``feed_attrs``/``feed_keyed`` documents for counts of
    feed ``k``: lanes ``(position, lane)`` pairs, keyed global positions,
    each encoded as one int64 (``position * lanes + lane`` for lanes)."""
    T = run.traffic.chunk
    nz = torch.nonzero(counts.sum(-1))
    if run.traffic.layout == "lanes":
        B = run.traffic.lanes
        code = (k * T + nz[:, 0]) * B + nz[:, 1]
    else:
        code = k * T + nz[:, 0]
    return code.cpu().numpy()


def sorted_slots(ring: torch.Tensor, width: int) -> torch.Tensor:
    """Each slot's state counts sorted, zero-padded to ``width``."""
    ring = ring.to(torch.float64)
    pad = width - ring.shape[-1]
    if pad:
        ring = torch.cat([ring, ring.new_zeros(ring.shape[:-1] + (pad,))],
                         -1)
    return torch.sort(ring, -1)[0]


def compare(run, dtype=torch.int64) -> dict:
    """Judge the program's outputs in ``run`` against the reference
    computed in ``dtype``.  Returns ``{name: (value, limit)}`` and the
    window feeds that failed as ``run.failed_feeds``."""
    counts_wrong = hits_wrong = totals_wrong = 0
    failed = set()
    cache = {}
    fill = run.traffic.fill_feeds(run.cfg["window"])
    P = run.traffic.pool_chunks

    def want(k):
        # feeds past the fill with the same pool chunk see the same
        # history, so they have the same answer
        key = ("phase", k % P) if k >= fill else ("feed", k)
        if key not in cache:
            c = expected(run, k, dtype)
            cache[key] = (c, int(torch.count_nonzero(c.sum(-1))))
        return cache[key]

    for k, n_hits in run.hit_lens.items():
        if want(k)[1] != n_hits:
            totals_wrong += 1
            failed.add(k)
    for k, (counts, hits) in run.kept.items():
        c = want(k)[0]
        got = torch.from_numpy(np.ascontiguousarray(counts)).to(c.device)
        bad = int((got.reshape(c.shape) != c).sum()) \
            if got.numel() == c.numel() else c.numel()
        bad_hits = int(np.setxor1d(hits, hits_of(run, k, c)).size)
        counts_wrong += bad
        hits_wrong += bad_hits
        if bad or bad_hits:
            failed.add(k)
    ref_ring = expected_ring(run, dtype)
    width = max(ref_ring.shape[-1], run.ring.shape[-1])
    ring_wrong = int((sorted_slots(run.ring, width)
                      != sorted_slots(ref_ring.to(run.ring.device), width)
                      ).any(-1).sum())
    run.failed_feeds = failed
    return {"counts_wrong": (counts_wrong, 0),
            "hits_wrong": (hits_wrong, 0),
            "hit_totals_wrong": (totals_wrong, 0),
            "ring_slots_wrong": (ring_wrong, 0)}
