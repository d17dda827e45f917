"""timed Enumerable Compact Set (tECS) — paper §5.1–5.2 and Algorithm 2.

A tECS is a DAG with three node kinds:

* **bottom** nodes — labelled with a stream position, no child (the start of an
  open complex event);
* **output** nodes — labelled with a stream position, one child ``next``;
* **union**  nodes — two children ``left``/``right`` with
  ``⟦u⟧ = ⟦left⟧ ∪ ⟦right⟧``.

Invariants maintained by the construction methods (``new_bottom``/``extend``/
``union``/``merge``):

* *time-ordered*: every node caches ``max_start``; for union nodes
  ``max_start(left) ≥ max_start(right)`` — enabling the window prune;
* *3-bounded*: output-depth ≤ 3 everywhere, via the "safe node" discipline
  (safe ⇔ non-union, or odepth(n) = 1 ∧ odepth(right(n)) ≤ 2);
* *duplicate-free*: guaranteed by the caller (I/O-determinism, Theorem 3).

Enumeration (Algorithm 2) is a stack-based DFS that visits left children first
and pushes right children only when their ``max_start`` passes the window
threshold — yielding output-linear delay (Theorem 2).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .events import ComplexEvent

BOTTOM = 0
OUTPUT = 1
UNION = 2


class Node:
    __slots__ = ("kind", "pos", "max_start", "left", "right")

    def __init__(self, kind: int, pos: int, max_start: int,
                 left: Optional["Node"] = None, right: Optional["Node"] = None):
        self.kind = kind
        self.pos = pos            # stream position (bottom/output only)
        self.max_start = max_start
        self.left = left          # union: left child; output: next
        self.right = right        # union: right child

    # -- structural helpers (used by tests / assertions) ---------------------
    def odepth(self) -> int:
        d, n = 0, self
        while n.kind == UNION:
            d += 1
            n = n.left
        return d

    def is_safe(self) -> bool:
        if self.kind != UNION:
            return True
        return self.odepth() == 1 and (self.right.odepth() <= 2)

    def __repr__(self):  # pragma: no cover
        k = {BOTTOM: "⊥", OUTPUT: "o", UNION: "∨"}[self.kind]
        return f"{k}(pos={self.pos}, max={self.max_start})"


class TECS:
    """The tECS ``E`` plus its construction methods (paper §5.2)."""

    def __init__(self, check_invariants: bool = False):
        self.nodes_created = 0
        self._check = check_invariants

    # -- node constructors ----------------------------------------------------
    def new_bottom(self, i: int) -> Node:
        self.nodes_created += 1
        return Node(BOTTOM, i, i)

    def extend(self, n: Node, j: int) -> Node:
        self.nodes_created += 1
        return Node(OUTPUT, j, n.max_start, left=n)

    def union(self, n1: Node, n2: Node) -> Node:
        """Fig. 5 gadgets (a)–(d).  Requires n1, n2 safe, max(n1) = max(n2)."""
        if self._check:
            assert n1.is_safe() and n2.is_safe()
            assert n1.max_start == n2.max_start
        m = n1.max_start
        self.nodes_created += 1
        if n1.kind != UNION:  # (a)
            return Node(UNION, -1, m, left=n1, right=n2)
        if n2.kind != UNION:  # (b)
            return Node(UNION, -1, m, left=n2, right=n1)
        # both unions: 3 new nodes keep everything time-ordered and 3-bounded
        self.nodes_created += 2
        if n1.right.max_start >= n2.right.max_start:  # (c)
            u2 = Node(UNION, -1, max(n1.right.max_start, n2.right.max_start),
                      left=n1.right, right=n2.right)
            u1 = Node(UNION, -1, m, left=n2.left, right=u2)
            u = Node(UNION, -1, m, left=n1.left, right=u1)
        else:  # (d)
            u2 = Node(UNION, -1, max(n1.right.max_start, n2.right.max_start),
                      left=n2.right, right=n1.right)
            u1 = Node(UNION, -1, m, left=n2.left, right=u2)
            u = Node(UNION, -1, m, left=n1.left, right=u1)
        if self._check:
            assert u.is_safe()
        return u


# ---------------------------------------------------------------------------
# Union-lists (paper §5.2): non-empty sequences n0, n1, ..., nk of safe nodes
# with n0 non-union, max(n0) ≥ max(ni), and max(nj) > max(n_{j+1}) for j ≥ 1.
# ---------------------------------------------------------------------------

UnionList = List[Node]


def new_ulist(n: Node) -> UnionList:
    return [n]


def ulist_insert(tecs: TECS, ul: UnionList, n: Node) -> UnionList:
    """In-place insert of safe node ``n`` with ``max(n) ≤ max(ul[0])``."""
    m = n.max_start
    for i in range(1, len(ul)):
        if ul[i].max_start == m:
            # replace n_i by union(n_i, n) — also updates E
            ul[i] = tecs.union(ul[i], n)
            return ul
        if ul[i].max_start < m:
            ul.insert(i, n)  # keeps positions ≥ 1 strictly decreasing
            return ul
    ul.append(n)  # smallest max-start so far (or max(n) = max(n0), len == 1)
    return ul


def ulist_merge(tecs: TECS, ul: UnionList) -> Node:
    """Fig. 5(e): fold the union-list into one safe node, right-chained."""
    if len(ul) == 1:
        return ul[0]
    acc = ul[-1]
    for i in range(len(ul) - 2, 0, -1):
        tecs.nodes_created += 1
        acc = Node(UNION, -1, ul[i].max_start, left=ul[i], right=acc)
    tecs.nodes_created += 1
    return Node(UNION, -1, ul[0].max_start, left=ul[0], right=acc)


def ulist_max(ul: UnionList) -> int:
    return ul[0].max_start


# ---------------------------------------------------------------------------
# Algorithm 2 — enumeration with output-linear delay.
# ---------------------------------------------------------------------------


def _make_ce(start, end, data, _new=ComplexEvent.__new__) -> ComplexEvent:
    """Hot-path :class:`ComplexEvent` constructor.

    Enumeration materializes one instance per match; the frozen-dataclass
    ``__init__`` costs three ``object.__setattr__`` calls, which dominates
    at high match counts.  Writing ``__dict__`` directly builds the same
    (equal, hashable) instance at a fraction of the cost.
    """
    ce = _new(ComplexEvent)
    d = ce.__dict__
    d["start"] = start
    d["end"] = end
    d["data"] = data
    return ce


def enumerate_arena(kind, pos, max_start, left, right, root: int, j: int,
                    threshold_start: Optional[int] = None,
                    steps: Optional[List[int]] = None
                    ) -> Iterator[ComplexEvent]:
    """Algorithm 2 over a structure-of-arrays tECS (device arena, DESIGN §7).

    Same stack DFS as :func:`enumerate_node`, but nodes are rows of int32
    arrays fetched from the device arena (``kind/pos/max_start/left/right``)
    and ``root`` is an arena index (< 0 = empty).  ``threshold_start`` is the
    window prune (``None`` disables it: arena roots only reference in-window
    nodes, the ring evicts expired starts before they can be shared).
    ``steps``, when given, is a 1-element list incremented once per node
    visit — the work counter the output-linear-delay tests measure.
    """
    if root < 0:
        return
    thr = -(1 << 62) if threshold_start is None else threshold_start
    if max_start[root] < thr:
        return
    stack: List[Tuple[int, Optional[tuple]]] = [(int(root), None)]
    while stack:
        node, plist = stack.pop()
        while True:
            if steps is not None:
                steps[0] += 1
            k = kind[node]
            if k == BOTTOM:
                data = []
                cell = plist
                while cell is not None:
                    data.append(cell[0])
                    cell = cell[1]
                yield ComplexEvent(int(pos[node]), j, tuple(data))
                break
            elif k == OUTPUT:
                plist = (int(pos[node]), plist)
                node = int(left[node])
            else:  # UNION
                r = int(right[node])
                if max_start[r] >= thr:
                    stack.append((r, plist))
                node = int(left[node])


def enumerate_arena_batch(kind, pos, max_start, left, right,
                          roots: Sequence[int], lanes: Sequence[int],
                          ends: Sequence[int], thresholds: Sequence[int],
                          caps: Optional[Sequence[int]] = None,
                          steps: Optional[List[int]] = None
                          ) -> List[List[ComplexEvent]]:
    """Frontier-vectorized Algorithm 2 (DESIGN §13).

    Runs many :func:`enumerate_arena` traversals at once: one root per entry
    of ``roots`` (arena row ids; < 0 = empty), each with its own arena lane
    (``kind``/``pos``/``max_start``/``left``/``right`` are ``(B, capacity)``
    arrays), end position and window threshold.  Instead of a per-node Python
    stack, a *frontier* of pending paths is expanded array-at-a-time: every
    sweep classifies all live rows by node kind, conses output labels into a
    shared pool, and unrolls each union row's whole union-list spine at once
    — the row continues into the list head, and one new row per remaining
    list element (``max_start`` passing the threshold) is inserted after it
    in list order.  Because the expansion is in place and left-first, the
    final order of finished rows is exactly the DFS yield order of
    Algorithm 2, and charging one step per node visit (live rows per sweep
    plus union spine nodes chased through) reproduces the DFS work counter
    — so the output-linear-delay accounting still binds.

    ``caps``, when given, bounds the number of matches kept per root (the
    ``islice`` early-exit of compiled LAST): rows whose finished-match rank
    within their root already reached the cap are pruned every sweep, so work
    stays proportional to the kept output rather than the full match set.
    With a cap the step counter can differ from a lazily-consumed DFS
    generator (the frontier advances breadth-wise past the cap boundary by
    one sweep); without caps the totals are identical.

    Returns one ``list[ComplexEvent]`` per root, each bit-identical (order
    included) to draining the DFS generator.
    """
    n_roots = len(roots)
    out: List[List[ComplexEvent]] = [[] for _ in range(n_roots)]
    if n_roots == 0:
        return out
    # Flattened arena views: 1-D ``take`` gathers are ~2-3x cheaper than 2-D
    # fancy indexing on the small frontiers this walk runs over, and the
    # per-row lane is fixed, so ``lane*capacity + node`` resolves every
    # (lane, node) pair with one fused multiply-add per sweep.
    cap_n = kind.shape[1]
    kind_f = np.ascontiguousarray(kind).reshape(-1)
    pos_f = np.ascontiguousarray(pos).reshape(-1)
    max_start_f = np.ascontiguousarray(max_start).reshape(-1)
    left_f = np.ascontiguousarray(left).reshape(-1)
    right_f = np.ascontiguousarray(right).reshape(-1)
    roots_a = np.asarray(roots, dtype=np.int64)
    lanes_a = np.asarray(lanes, dtype=np.int64)
    thr_a = np.asarray(thresholds, dtype=np.int64)
    caps_a = None if caps is None else np.asarray(caps, dtype=np.int64)
    ok = roots_a >= 0
    safe_root = np.where(ok, roots_a, 0)
    ok &= max_start_f.take(lanes_a * cap_n + safe_root) >= thr_a
    if caps_a is not None:
        ok &= caps_a > 0
    ridx = np.nonzero(ok)[0]
    if ridx.size == 0:
        return out
    # Frontier state (one row per pending DFS path, in DFS yield order).
    node = roots_a[ridx]
    lane = lanes_a[ridx]
    lbase = lane * cap_n
    rthr = thr_a[ridx]
    plist = np.full(ridx.size, -1, dtype=np.int64)   # cons-list head id
    done = np.zeros(ridx.size, dtype=bool)
    start = np.zeros(ridx.size, dtype=np.int64)
    # Shared cons pool (pos, parent) — O(1) amortized append via doubling.
    pp_pos = np.empty(1024, dtype=np.int64)
    pp_par = np.empty(1024, dtype=np.int64)
    pp_len = 0
    n_steps = 0
    while True:
        act = ~done
        n_act = int(act.sum())
        if n_act == 0:
            break
        n_steps += n_act
        fl = lbase + node
        k = np.where(act, kind_f.take(fl), -1)
        is_b = k == BOTTOM
        is_o = k == OUTPUT
        is_u = k == UNION
        if is_o.any():
            flo = fl[is_o]
            n_o = flo.size
            while pp_len + n_o > pp_pos.size:
                pp_pos = np.concatenate([pp_pos, np.empty_like(pp_pos)])
                pp_par = np.concatenate([pp_par, np.empty_like(pp_par)])
            pp_pos[pp_len:pp_len + n_o] = pos_f.take(flo)
            pp_par[pp_len:pp_len + n_o] = plist[is_o]
            plist[is_o] = pp_len + np.arange(n_o)
            pp_len += n_o
            node[is_o] = left_f.take(flo)
        if is_b.any():
            start[is_b] = pos_f.take(fl[is_b])
            done |= is_b
        if is_u.any():
            # Unroll each row's whole union-list spine (the right-chain) in
            # ONE sweep instead of one node per sweep: the row continues
            # into the list head ``left(u)``; chase level ℓ spawns the row
            # for list element ℓ+1 (``left`` of a union spine node, or the
            # chain-tail node itself).  Chasing past a union spine node
            # charges its DFS visit here; non-union spawns are charged when
            # their row is processed.  Spawns insert after the parent in
            # ascending-level order — exactly the order the per-sweep
            # expansion produced, so DFS yield order is preserved.
            ui = np.nonzero(is_u)[0]
            ut = rthr[ui]
            ufl = fl[ui]
            node[ui] = left_f.take(ufl)       # continue into the list head
            lv_rows: List[np.ndarray] = []    # per level: local ids into ui
            lv_nodes: List[np.ndarray] = []
            al = np.arange(ui.size)           # rows still on the spine
            ab = lbase[ui]                    # their lane*capacity bases
            athr = ut
            afl = ufl
            lv = 0
            while al.size:
                if lv:
                    # every row entering level >= 1 got here by chasing
                    # through a union spine node — charge its DFS visit
                    # (equals the per-level ru count without a sum sync)
                    n_steps += al.size
                lv += 1
                r = right_f.take(afl)
                rfl = ab + r
                ex = max_start_f.take(rfl) >= athr
                al = al[ex]
                if al.size == 0:
                    break
                r, rfl, ab, athr = r[ex], rfl[ex], ab[ex], athr[ex]
                ru = kind_f.take(rfl) == UNION
                lv_rows.append(al)
                lv_nodes.append(np.where(
                    ru, left_f.take(np.where(ru, rfl, 0)), r))
                al, ab, athr, afl = al[ru], ab[ru], athr[ru], rfl[ru]
            if lv_rows:
                # A row stays on the spine through consecutive chase levels,
                # so its spawn at level l has within-parent rank exactly l —
                # all levels scatter into the rebuilt frontier in ONE pass.
                n_sp = np.zeros(ui.size, dtype=np.int64)
                for lr in lv_rows:
                    n_sp[lr] += 1
                cnt = np.ones(node.size, dtype=np.int64)
                cnt[ui] += n_sp
                offs = np.cumsum(cnt) - cnt
                total = int(offs[-1] + cnt[-1])
                src = np.concatenate([ui[lr] for lr in lv_rows])
                at = np.concatenate([offs[ui[lr]] + 1 + lv
                                     for lv, lr in enumerate(lv_rows)])
                nodes_cat = np.concatenate(lv_nodes)
                new = {}
                for name, arr in (("node", node), ("lane", lane),
                                  ("rthr", rthr), ("plist", plist),
                                  ("ridx", ridx), ("start", start),
                                  ("done", done)):
                    na = np.empty(total, dtype=arr.dtype)
                    na[offs] = arr
                    na[at] = nodes_cat if name == "node" else (
                        False if name == "done" else arr[src])
                    new[name] = na
                node, lane, rthr, plist, ridx, start, done = (
                    new["node"], new["lane"], new["rthr"], new["plist"],
                    new["ridx"], new["start"], new["done"])
                lbase = lane * cap_n
        if caps_a is not None:
            # Prune rows whose match rank within their root already reached
            # the cap — they can only produce matches past the islice cutoff.
            done_excl = np.cumsum(done) - done
            seg_first = np.searchsorted(ridx, ridx)   # rows sorted by ridx
            rank = done_excl - done_excl[seg_first]
            keep = rank < caps_a[ridx]
            if not keep.all():
                node, lane, rthr, plist, ridx, start, done = (
                    node[keep], lane[keep], rthr[keep], plist[keep],
                    ridx[keep], start[keep], done[keep])
                lbase = lbase[keep]
    if steps is not None:
        steps[0] += n_steps
    if done.size == 0:
        return out
    # Reconstruct data tuples: walking a cons list from its head yields the
    # marked positions in ascending order (deepest output consed last), so
    # column i of the gather matrix is element i of each tuple.
    ends_l = [int(e) for e in ends]
    cur = plist.copy()
    cols = []
    while True:
        valid = cur >= 0
        if not valid.any():
            break
        safe = np.where(valid, cur, 0)
        cols.append(np.where(valid, pp_pos[safe], -1))
        cur = np.where(valid, pp_par[safe], -1)
    starts_l = start.tolist()
    ends_row = np.asarray(ends_l, dtype=np.int64)[ridx].tolist()
    mk = _make_ce
    if not cols:
        ces = list(map(mk, starts_l, ends_row, ((),) * len(starts_l)))
    elif bool((cols[-1] >= 0).all()):
        # homogeneous data sizes (padding appears only in trailing
        # columns): zip(*) conses every data tuple at C speed
        ces = list(map(mk, starts_l, ends_row,
                       zip(*[c.tolist() for c in cols])))
    else:
        mat = np.stack(cols, axis=1)
        lens_l = (mat >= 0).sum(axis=1).tolist()
        ces = [mk(s, e, tuple(row[:n])) for s, e, row, n in
               zip(starts_l, ends_row, mat.tolist(), lens_l)]
    # Rows of one root stay contiguous (spawns insert next to their parent)
    # and roots in input order, so ridx is non-decreasing: split by
    # boundaries instead of appending row by row.
    if np.all(ridx[:-1] <= ridx[1:]):
        bounds = np.searchsorted(ridx, np.arange(n_roots + 1)).tolist()
        for ri in range(n_roots):
            lo, hi = bounds[ri], bounds[ri + 1]
            if lo != hi:
                out[ri] = ces[lo:hi]
    else:  # pragma: no cover — defensive; insertion order keeps ridx sorted
        for ri, ce in zip(ridx.tolist(), ces):
            out[ri].append(ce)
    if caps_a is not None:
        for ri in set(ridx.tolist()):
            out[ri] = out[ri][:int(caps_a[ri])]
    return out


def enumerate_node(n: Node, j: int, threshold_start: int
                   ) -> Iterator[ComplexEvent]:
    """Enumerate ``⟦n⟧ε(j)`` = complex events closed at ``j`` whose start
    position is ``≥ threshold_start`` (i.e. within the window).

    ``threshold_start`` is ``j - ε`` for count-based windows; for time-based
    windows the engine maps the timestamp bound back to the earliest admissible
    start *position* before calling (stream order = time order).
    """
    if n.max_start < threshold_start:
        return
    # Stack entries: (node, reversed linked list of marked positions).  The
    # linked-list representation makes pushing a snapshot O(1) (paper B.1).
    stack: List[Tuple[Node, Optional[tuple]]] = [(n, None)]
    while stack:
        node, plist = stack.pop()
        while True:
            if node.kind == BOTTOM:
                # ⟦p̄⟧ = (i, D): i = pos(bottom); D = labels of the *output*
                # nodes along the full-path (the bottom's own position is the
                # start of the interval, not automatically part of D).
                # The path visits output nodes latest-first and conses each onto
                # the list head, so walking the cons list yields ascending order.
                data = []
                cell = plist
                while cell is not None:
                    data.append(cell[0])
                    cell = cell[1]
                yield ComplexEvent(node.pos, j, tuple(data))
                break
            elif node.kind == OUTPUT:
                plist = (node.pos, plist)
                node = node.left
            else:  # UNION
                if node.right.max_start >= threshold_start:
                    stack.append((node.right, plist))
                node = node.left
