"""PARTITION BY evaluation (paper §3 semantics, §5.4 implementation).

The stream is logically split into maximal substreams that agree (and are
non-NULL) on every partition attribute; WHERE-SELECT-WITHIN runs on each
substream separately.  CORE implements this by hashing the attribute values
and running one engine instance per partition — here a dict of engines.

Each partition engine evaluates over its substream with *local* positions
(count-based windows therefore count events of the substream, matching the
"executes WHERE-SELECT-WITHIN on each substream separately" semantics); the
returned complex events are relabelled back to global stream positions.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, Iterable, List, Optional, Tuple

from .events import ComplexEvent, Event, NULL

# Device-side key sentinels (vector/partitioned.py).  Partition-key hashes
# are clamped below EMPTY_LANE so real keys can never collide with either.
NULL_KEY_HASH = 0xFFFFFFFF   # tuple is NULL on a partition attribute → drop
EMPTY_LANE = 0xFFFFFFFE      # lane-table slot owned by no partition


def partition_key(t: Event, attrs: Tuple[str, ...]) -> Optional[tuple]:
    """The tuple of partition-attribute values, or None for NULL keys.

    Paper §3: tuples NULL on any partition attribute join no substream —
    both the host dict-of-engines and the device lane router drop them.
    """
    key = tuple(t.get(a) for a in attrs)
    if any(v is NULL for v in key):
        return None
    return key


def stable_key_hash(key: Optional[tuple]) -> int:
    """Deterministic 32-bit FNV-1a hash of a partition key.

    Python's ``hash()`` is salted per process for strings, so it cannot be
    the routing hash (restarts would re-shuffle partitions).  Numeric values
    are canonicalized the way Python dict keys compare (``1 == 1.0 == True``
    land in one partition), matching the host ``PartitionedEngine``'s dict
    semantics.  Hashes ≥ EMPTY_LANE are folded down so sentinels stay
    unreachable.
    """
    if key is None:
        return NULL_KEY_HASH
    h = 0x811C9DC5
    for v in key:
        if isinstance(v, str):
            data = b"s" + v.encode("utf-8")
        elif isinstance(v, (bool, int)) or hasattr(v, "__index__"):
            # exact integer canonical form (also numpy integer scalars via
            # __index__) — never via float, which would collapse distinct
            # ints ≥ 2⁵³ and overflow on huge ints
            data = b"i" + str(int(v)).encode()
        elif isinstance(v, float) or hasattr(v, "is_integer"):
            # floats incl. numpy floating scalars: integral values share the
            # exact-int form (dict semantics: 1 == 1.0 == np.float32(1.0))
            f = float(v)
            data = (b"i" + str(int(f)).encode() if f.is_integer()
                    else b"f" + repr(f).encode())
        else:
            data = b"o" + repr(v).encode()
        for byte in data:
            h = ((h ^ byte) * 0x01000193) & 0xFFFFFFFF
        h = ((h ^ 0xAA) * 0x01000193) & 0xFFFFFFFF   # component separator
    return h if h < EMPTY_LANE else h - 2


class PartitionedEngine:
    def __init__(self, make_engine: Callable[[], "object"],
                 attrs: Tuple[str, ...]):
        self.make_engine = make_engine
        self.attrs = attrs
        self.partitions: Dict[Hashable, object] = {}
        self.j = -1

    def process(self, t: Event) -> List[ComplexEvent]:
        self.j += 1
        key = partition_key(t, self.attrs)
        if key is None:
            return []  # tuples NULL on a partition attribute join no substream
        eng = self.partitions.get(key)
        if eng is None:
            eng = self.make_engine()
            self.partitions[key] = eng
        # Each partition engine sees only its substream; positions inside the
        # engine are per-substream, and we relabel outputs to global positions.
        pos_map = getattr(eng, "_global_positions", None)
        if pos_map is None:
            pos_map = []
            eng._global_positions = pos_map
        pos_map.append(self.j)
        out = eng.process(t)
        return [ComplexEvent(pos_map[c.start], pos_map[c.end],
                             tuple(pos_map[p] for p in c.data))
                for c in out]

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)
