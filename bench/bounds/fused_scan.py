"""Least time of one feed's windowed counting scan on the card.

The algorithm's work, whatever kernels run: every event read moves each
live ring slot (``window + 1`` of them a substream) through one sparse
step of each query's counting automaton, and every live slot adds its
final state to the count.  For ``X ; Y ; Z`` a step has ``4 + [X] + 2[Y]
+ 2[Z]`` non-zeros (the run carried forward in its four progress states,
a start on X, one step of progress on Y and on Z), and the final state
one more, each a multiply and an add in float32.  Bytes: the ring of
``7 Q`` states a slot read and written once, the events' type codes read
and the counts written once, and the dense transition tables (``2^k``
classes of ``7Q x 7Q``, ``k`` the distinct types) read once.  The least
time is the larger of operations at the float32 peak and bytes at the
HBM peak.  The arithmetic is that of the port's ``chip_smoke.py``
(``scan_bound``), counted from the traffic instead of the program's
tables.
"""
from bench import peaks

STATES = 7


def _types_of(seq: str, names) -> tuple:
    """Type indices of a sequence's steps (``len(names)``: never drawn)."""
    steps = [t.strip() for t in seq.split(";")]
    return tuple(names.index(t) if t in names else len(names) for t in steps)


def work(traffic, cfg, k: int) -> tuple:
    """(flops, bytes) of feed ``k``'s scan."""
    names = traffic.type_names
    c = traffic.chunk_of(k)
    types = traffic.types[c].long()
    if traffic.layout == "keyed":
        types = types[traffic.keys[c] >= 0]
    n_events = types.numel()
    per_type = [int((types == t).sum()) for t in range(len(names))] + [0]
    Q = len(cfg["queries"])
    nnz = 0
    used = set()
    for seq in cfg["queries"]:
        x, y, z = _types_of(seq, names)
        used |= {t.strip() for t in seq.split(";")}
        nnz += 4 * n_events + per_type[x] + 2 * per_type[y] \
            + 2 * per_type[z] + n_events
    W = cfg["window"] + 1
    flops = 2 * W * nnz
    S = STATES * Q
    C = 2 ** len(used)
    T = traffic.chunk
    lanes = cfg["lanes"]
    events_in = T * lanes if traffic.layout == "lanes" else T
    nbytes = 4 * (2 * lanes * W * S + events_in + events_in * Q
                  + C * S * S + Q * S + S)
    return flops, nbytes


def seconds(traffic, cfg, k: int) -> float:
    flops, nbytes = work(traffic, cfg, k)
    return max(flops / peaks.F32_FLOP_PER_S, nbytes / peaks.HBM_BYTES_PER_S)
