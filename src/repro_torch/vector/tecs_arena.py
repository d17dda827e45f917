"""The tECS arena on the device: enumeration from device state.

The tECS is kept on the device as a structure-of-arrays node store —
``kind/pos/maxs/left/right`` int32 tensors of shape ``(B, capacity + 1)``
with a per-lane bump pointer and overflow latch — beside a ``(B, W, S)``
cell table keyed by (start slot, det state).  Every run in a cell shares
one start position, hence one max-start, which is what lets the paper's
union gadgets (Fig. 5 a–d) run cell-wise in parallel.  At hits one root per
query is built (same-slot folds, then the Fig. 5(e) right-chain in
decreasing start order), ready for Algorithm 2 on the host
(:func:`repro_torch.core.tecs.enumerate_arena_batch`).

Two implementations with one contract:

* ``"block"`` (:func:`arena_scan_block`, the default): the builder
  (:func:`repro_torch.kernels.ops.arena_store_update` — the Hopper store
  kernel on CUDA, its plain version on the CPU) carries the cell table over
  the chunk, allocates node ids in the per-event fold's order and writes
  each node straight into the store.  Segmented chunks (``n_seg > 1``)
  take the TPU kernel's contract instead: fixed-layout node records on
  virtual ids, one chunk-level cumsum assigning real ids and one batched
  store update (:func:`_arena_translate_store`).
* ``"fold"`` (:func:`arena_scan`): the per-event reference fold, plain
  PyTorch.  Its allocation order is what the block layout replays, so the
  two give bit-identical stores on lanes that do not overflow.

Index ``capacity`` of every store row is the overflow sink: a lane whose
pointer would pass capacity latches ``ovf``, clamps further writes into the
sink, and refuses to enumerate (:class:`ArenaOverflow`) until it is reset.
Both implementations update the arena dict's tensors in place.

Node ids are bump-ordered, so children have smaller ids than their parents.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.events import ComplexEvent
from ..core.tecs import (BOTTOM, OUTPUT, UNION, enumerate_arena,
                         enumerate_arena_batch)
from ..kernels import ref as kref
from ..kernels import window as wkern

NULL = -1  # empty cell / absent child
_NO_CAP = 1 << 62  # per-root match cap meaning "unbounded" (enumerate_batch)

ARENA_IMPLS = ("block", "fold")  # block: vectorized (default); fold: per-event

_NODE_FIELDS = ("kind", "pos", "maxs", "left", "right")


def check_arena_impl(arena_impl: str) -> str:
    """Validate an ``arena_impl`` selector."""
    if arena_impl not in ARENA_IMPLS:
        raise ValueError(
            f"arena_impl must be one of {ARENA_IMPLS}, got {arena_impl!r}")
    return arena_impl


# ---------------------------------------------------------------------------
# static tables: predecessor lists of the det CEA, by (class, target state)
# ---------------------------------------------------------------------------


@dataclass
class ArenaTables:
    """Per-query static tables driving the arena update (numpy, host).

    ``pred_*[c, s', k]`` lists the ≤ K predecessor edges into det state
    ``s'`` under symbol class ``c``: source state, marking flag (• = extend,
    ◦ = pass-through) and a validity mask for the padded tail.
    """

    pred_idx: np.ndarray     # (C, S, K) int32 source det state
    pred_mark: np.ndarray    # (C, S, K) bool — True: •-edge (extend)
    pred_valid: np.ndarray   # (C, S, K) bool
    finals_sq: np.ndarray    # (S, Q) bool — final-state masks, per query
    init_states: Tuple[int, ...]  # seed targets
    num_states: int
    num_queries: int
    max_indegree: int


def build_tables(delta_mark: np.ndarray, delta_unmark: np.ndarray,
                 finals_q: np.ndarray, init_states: Sequence[int]
                 ) -> ArenaTables:
    """Invert forward ``delta`` tables into per-target predecessor lists.

    delta_mark/delta_unmark: (S, C) int32 forward maps, 0 = dead (dropped).
    finals_q: (Q, S) bool/float final-state masks.
    """
    dm = np.asarray(delta_mark)
    du = np.asarray(delta_unmark)
    S, C = dm.shape
    preds: List[List[List[Tuple[int, bool]]]] = \
        [[[] for _ in range(S)] for _ in range(C)]
    for p in range(1, S):          # dead state 0 is never a source
        for c in range(C):
            t = int(dm[p, c])
            if t != 0:
                preds[c][t].append((p, True))   # marks first: extends are
            t = int(du[p, c])                   # non-union, cheapest gadget
            if t != 0:
                preds[c][t].append((p, False))
    K = max(1, max(len(preds[c][s]) for c in range(C) for s in range(S)))
    pred_idx = np.zeros((C, S, K), np.int32)
    pred_mark = np.zeros((C, S, K), bool)
    pred_valid = np.zeros((C, S, K), bool)
    for c in range(C):
        for s in range(S):
            for k, (p, m) in enumerate(preds[c][s]):
                pred_idx[c, s, k] = p
                pred_mark[c, s, k] = m
                pred_valid[c, s, k] = True
    fq = np.asarray(finals_q).astype(bool)
    return ArenaTables(
        pred_idx=pred_idx, pred_mark=pred_mark, pred_valid=pred_valid,
        finals_sq=np.ascontiguousarray(fq.T),
        init_states=tuple(int(s) for s in init_states),
        num_states=S, num_queries=fq.shape[0], max_indegree=K)


def tables_from_symbolic(symbolic) -> ArenaTables:
    """Arena tables for a single :class:`~repro_torch.vector.symbolic.
    SymbolicCEA`."""
    return build_tables(symbolic.delta_mark, symbolic.delta_unmark,
                        symbolic.finals[None, :], (symbolic.initial,))


def tables_from_packed(symbolics, offsets, class_of, reps) -> ArenaTables:
    """Arena tables of the packed multi-query engine (block-diagonal CEA).

    ``reps[c]`` is a representative bit-vector of joint class ``c``; each
    query block maps it through its own class partition.  Block-local dead
    states (0) stay "none"; live targets and sources shift by the block
    offset.
    """
    n_classes = int(np.asarray(class_of).max()) + 1
    S_hat = sum(s.num_states for s in symbolics)
    dm = np.zeros((S_hat, n_classes), np.int32)
    du = np.zeros((S_hat, n_classes), np.int32)
    finals = np.zeros((len(symbolics), S_hat), bool)
    inits = []
    for qi, sym in enumerate(symbolics):
        off = offsets[qi]
        for c in range(n_classes):
            cq = int(sym.class_of[reps[c]])
            for s in range(1, sym.num_states):
                t = int(sym.delta_mark[s, cq])
                if t != 0:
                    dm[off + s, c] = off + t
                t = int(sym.delta_unmark[s, cq])
                if t != 0:
                    du[off + s, c] = off + t
        finals[qi, off:off + sym.num_states] = sym.finals
        inits.append(off + sym.initial)
    return build_tables(dm, du, finals, inits)


def _cached(tables: ArenaTables, name: str, key, make):
    cache = getattr(tables, "_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(tables, "_cache", cache)
    if (name, key) not in cache:
        cache[(name, key)] = make()
    return cache[(name, key)]


def _block_layout(tables: ArenaTables, W: int, epsilon: int, cap: int
                  ) -> kref.ArenaBlockLayout:
    """Static slot layout for (tables, ring, capacity) — cached on tables."""
    return _cached(tables, "layout", (W, epsilon, cap),
                   lambda: kref.arena_block_layout(
                       W, tables.num_states, tables.max_indegree,
                       tables.num_queries, epsilon, cap, tables.init_states,
                       tables.finals_sq, tables.pred_mark,
                       tables.pred_valid))


def _ptab(tables: ArenaTables, device) -> torch.Tensor:
    """Packed (C, S, K, 3) int32 predecessor tables on ``device``."""
    return _cached(tables, "ptab", str(device),
                   lambda: torch.from_numpy(kref.pack_pred_tables(
                       tables.pred_idx, tables.pred_mark,
                       tables.pred_valid)).to(device))


def _finals(tables: ArenaTables, device) -> torch.Tensor:
    """(S, Q) int32 finals on ``device``."""
    return _cached(tables, "finals", str(device),
                   lambda: torch.from_numpy(
                       tables.finals_sq.astype(np.int32)).to(device))


# ---------------------------------------------------------------------------
# device arena state
# ---------------------------------------------------------------------------


def init_arena(batch: int, capacity: int, ring: int, num_states: int,
               device="cpu") -> dict:
    """Fresh arena: per-lane node store, cell table and bump pointer.

    Index ``capacity`` of every field row is the overflow sink slot.
    Layout and dtypes are the reference package's, so snapshots move
    between the two.
    """
    shape = (batch, capacity + 1)

    def null(shape_):
        return torch.full(shape_, NULL, dtype=torch.int32, device=device)

    arena = {name: null(shape) for name in _NODE_FIELDS}
    arena["cell"] = null((batch, ring, num_states))
    arena["ptr"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    arena["ovf"] = torch.zeros((batch,), dtype=torch.bool, device=device)
    return arena


def reset_arena(arena: dict) -> None:
    """Empty an arena in place (its buffers are kept)."""
    for name in _NODE_FIELDS + ("cell",):
        arena[name].fill_(NULL)
    arena["ptr"].zero_()
    arena["ovf"].zero_()


# ---------------------------------------------------------------------------
# the per-event reference fold
# ---------------------------------------------------------------------------


def _alloc(ar: dict, need: torch.Tensor) -> torch.Tensor:
    """Bump-allocate ``need[b, m]`` nodes per slot; returns the base id per
    slot.  Lanes that pass capacity latch ``ovf``; their ids clamp into the
    sink at write time."""
    cap = ar["kind"].shape[1] - 1
    csum = torch.cumsum(need, dim=1, dtype=torch.int32)
    base = ar["ptr"][:, None] + csum - need
    new_ptr = ar["ptr"] + csum[:, -1]
    ar["ovf"] |= new_ptr > cap
    ar["ptr"].copy_(new_ptr.clamp(max=cap))
    return base


def _write(ar: dict, ids: torch.Tensor, mask: torch.Tensor, **fields
           ) -> None:
    """Masked SoA scatter of one node per (lane, slot); invalid → sink."""
    cap = ar["kind"].shape[1] - 1
    b = torch.arange(ids.shape[0], device=ids.device)[:, None].expand_as(ids)
    wid = torch.where(mask & (ids < cap), ids, cap).long()
    for name in _NODE_FIELDS:
        v = torch.as_tensor(fields[name], dtype=torch.int32,
                            device=ids.device)
        ar[name][b, wid] = torch.broadcast_to(v, ids.shape)


def _gather(field: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """field[b, ids[b, m]] with NULL-safe clamping (callers mask)."""
    return torch.gather(field, 1, ids.clamp(0, field.shape[1] - 1).long())


def _union_fold(ar: dict, acc: torch.Tensor, contrib: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """One fold iteration of the paper's ``union`` (Fig. 5 gadgets (a)–(d)).

    acc/contrib/valid: (B, M) node ids and mask.  Where ``valid``: ``acc :=
    acc is NULL ? contrib : union(acc, contrib)``.  Inputs share their
    max-start; the result is safe, time-ordered and output-depth ≤ 3.
    """
    cap = ar["kind"].shape[1] - 1
    has_acc = acc != NULL
    do_u = valid & has_acc
    ka = _gather(ar["kind"], acc) == UNION
    kc = _gather(ar["kind"], contrib) == UNION
    both = do_u & ka & kc
    single = do_u & ~both
    need = torch.where(do_u, torch.where(both, 3, 1), 0).to(torch.int32)
    base = _alloc(ar, need)

    m = torch.maximum(_gather(ar["maxs"], acc), _gather(ar["maxs"], contrib))
    case_a = single & ~ka
    l1 = torch.where(case_a, acc, contrib)
    r1 = torch.where(case_a, contrib, acc)
    n1l, n1r = _gather(ar["left"], acc), _gather(ar["right"], acc)
    n2l, n2r = _gather(ar["left"], contrib), _gather(ar["right"], contrib)
    m1r, m2r = _gather(ar["maxs"], n1r), _gather(ar["maxs"], n2r)
    ge = m1r >= m2r
    # id0: the single-case union, or u2 = n1.right ∪ n2.right (time-ordered)
    _write(ar, base, single | both, kind=UNION, pos=NULL,
           maxs=torch.where(single, m, torch.maximum(m1r, m2r)),
           left=torch.where(single, l1, torch.where(ge, n1r, n2r)),
           right=torch.where(single, r1, torch.where(ge, n2r, n1r)))
    # id1: u1 = n2.left ∨ u2 ; id2: u = n1.left ∨ u1
    _write(ar, base + 1, both, kind=UNION, pos=NULL, maxs=m, left=n2l,
           right=base.clamp(max=cap))
    _write(ar, base + 2, both, kind=UNION, pos=NULL, maxs=m, left=n1l,
           right=(base + 1).clamp(max=cap))
    return torch.where(
        do_u, torch.where(both, (base + 2).clamp(max=cap),
                          base.clamp(max=cap)),
        torch.where(valid, contrib, acc))


def arena_scan(tables: ArenaTables, arena: dict, class_ids: torch.Tensor,
               gpos: torch.Tensor, start, valid, hits: torch.Tensor, *,
               epsilon: int, expire=None, consume=None
               ) -> Tuple[dict, torch.Tensor]:
    """Maintain the tECS arena over one chunk — the per-event reference fold.

    class_ids: (T, B) int32 symbol classes; gpos: (T, B) int32 global
    positions (node labels); start: (B,) ring-local offsets; valid: (B,)
    dense prefix of real events per lane; hits: (T, B, Q) bool from the
    counting scan.  ``expire`` ((T, B, W) bool, optional): time-eviction
    masks (``epsilon`` then only sets the chain extent, ``ring − 1``);
    ``consume`` ((T, B, S) bool, optional): CONSUME BY ANY clear masks,
    applied after each event's roots.  Updates ``arena`` in place and
    returns it with roots (T, B, Q) int32, NULL where no hit.
    """
    T, B = class_ids.shape
    W = arena["cell"].shape[1]
    S = tables.num_states
    Q = tables.num_queries
    cap = arena["kind"].shape[1] - 1
    dev = class_ids.device
    arange_w = torch.arange(W, device=dev)
    b_idx = torch.arange(B, device=dev)
    start = kref.lane_vector(start, B, dev)
    valid = kref.lane_vector(valid, B, dev, "valid_counts")
    hits = torch.as_tensor(hits, device=dev).bool()
    pred_idx = torch.from_numpy(tables.pred_idx).to(dev)
    pred_mark = torch.from_numpy(tables.pred_mark).to(dev)
    pred_valid = torch.from_numpy(tables.pred_valid).to(dev)
    finals_sq = torch.from_numpy(tables.finals_sq).to(dev)
    roots_out = []
    for t in range(T):
        cls_t, gpos_t, hit_t = class_ids[t].long(), gpos[t], hits[t]
        j = start + t
        live = t < valid
        seed = arange_w[None, :] == (j % W)[:, None]
        if expire is None:
            expire_t = arange_w[None, :] == ((j - epsilon - 1) % W)[:, None]
        else:
            expire_t = expire[t].bool()
        clear = (seed | expire_t) & live[:, None]
        cell = torch.where(clear[:, :, None], NULL, arena["cell"])

        # -- new_bottom(j) at the seed slot's initial state(s) -------------
        base = _alloc(arena, live.to(torch.int32)[:, None])
        id_bot = base[:, 0]
        _write(arena, base, live[:, None], kind=BOTTOM, pos=gpos_t[:, None],
               maxs=gpos_t[:, None], left=NULL, right=NULL)
        seed_slot = j % W
        for s0 in tables.init_states:
            old = cell[b_idx, seed_slot, s0]
            cell[b_idx, seed_slot, s0] = torch.where(
                live, id_bot.clamp(max=cap), old)

        # -- transition: fold predecessor edges into each (slot, state) ----
        acc = torch.full((B, W * S), NULL, dtype=torch.int32, device=dev)
        for k in range(tables.max_indegree):
            pk = pred_idx[cls_t, :, k]                          # (B, S)
            mk = pred_mark[cls_t, :, k]
            vk = pred_valid[cls_t, :, k]
            src = torch.gather(cell, 2, pk.clamp(0, S - 1).long()[
                :, None, :].expand(B, W, S))
            cvalid = vk[:, None, :] & (src != NULL) & live[:, None, None]
            m_ext = (cvalid & mk[:, None, :]).reshape(B, W * S)
            base_e = _alloc(arena, m_ext.to(torch.int32))
            src_f = src.reshape(B, W * S)
            _write(arena, base_e, m_ext, kind=OUTPUT, pos=gpos_t[:, None],
                   maxs=_gather(arena["maxs"], src_f), left=src_f,
                   right=NULL)
            contrib = torch.where(m_ext, base_e.clamp(max=cap), src_f)
            acc = _union_fold(arena, acc, contrib, cvalid.reshape(B, W * S))
        cell = torch.where(live[:, None, None], acc.reshape(B, W, S),
                           arena["cell"])

        # -- roots at hit positions: same-slot folds, then the chain -------
        slotacc = torch.full((B, W * Q), NULL, dtype=torch.int32, device=dev)
        for s in range(S):
            cell_s = cell[:, :, s]
            cval = ((cell_s != NULL)[:, :, None] & finals_sq[s][None, None, :]
                    & hit_t[:, None, :])
            slotacc = _union_fold(
                arena, slotacc,
                cell_s[:, :, None].expand(B, W, Q).reshape(B, W * Q),
                cval.reshape(B, W * Q))
        slotacc = slotacc.reshape(B, W, Q)
        root = torch.full((B, Q), NULL, dtype=torch.int32, device=dev)
        for d in range(epsilon, -1, -1):
            slot_d = (j - d) % W
            m_node = slotacc[b_idx, slot_d]                     # (B, Q)
            vm = (m_node != NULL) & hit_t
            need = (vm & (root != NULL)).to(torch.int32)
            base_c = _alloc(arena, need)
            _write(arena, base_c, need > 0, kind=UNION, pos=NULL,
                   maxs=_gather(arena["maxs"], m_node), left=m_node,
                   right=root)
            root = torch.where(vm, torch.where(root != NULL,
                                               base_c.clamp(max=cap),
                                               m_node), root)

        # CONSUME BY ANY: emitted roots keep their nodes; the *cells* of
        # consuming queries drop so no later match extends a consumed run
        if consume is not None:
            cell = torch.where(consume[t].bool()[:, None, :]
                               & live[:, None, None], NULL, cell)
        arena["cell"].copy_(cell)
        roots_out.append(torch.where(hit_t, root, NULL))
    roots = (torch.stack(roots_out) if roots_out else
             torch.full((0, B, Q), NULL, dtype=torch.int32, device=dev))
    return arena, roots


# ---------------------------------------------------------------------------
# the block-vectorized arena scan — same contract as arena_scan
# ---------------------------------------------------------------------------


def chunk_cells(arena: dict):
    """The chunk-start cell table of the builder — ``(id, is-union, left,
    right)`` (B, W, S) int32, the attributes gathered from the node store —
    and the (B, W) start of each ring slot (NULL where empty)."""
    cid0 = arena["cell"]
    cap = arena["kind"].shape[1] - 1
    occ = cid0 != NULL
    safe = cid0.clamp(0, cap).long().reshape(cid0.shape[0], -1)

    def at(name):
        return torch.gather(arena[name], 1, safe).reshape(cid0.shape)

    cells0 = (cid0, ((at("kind") == UNION) & occ).to(torch.int32),
              at("left"), at("right"))
    return cells0, torch.where(occ, at("maxs"), NULL).amax(dim=2)


def arena_scan_block(tables: ArenaTables, arena: dict,
                     class_ids: torch.Tensor, gpos: torch.Tensor, start,
                     valid, hits: torch.Tensor, *, epsilon: int,
                     expire=None, consume=None, impl: str = "fused",
                     n_seg: int = 1) -> Tuple[dict, torch.Tensor]:
    """Block-vectorized :func:`arena_scan` — same contract and results.

    With ``n_seg == 1`` (what every engine passes) one call of
    :func:`repro_torch.kernels.ops.arena_store_update` (the store kernel
    for CUDA tensors with ``impl="fused"``, its plain version otherwise)
    folds the chunk, allocates ids and writes the store.  With ``n_seg >
    1`` the builder (:func:`repro_torch.kernels.ops.arena_block_update`)
    emits fixed-layout records on virtual ids over ``n_seg`` parallel
    segments and :func:`_arena_translate_store` assigns real ids with one
    chunk-level cumsum and updates the store.  Both give the same ids;
    ``arena`` is updated in place.
    """
    from ..kernels import ops
    T, B = class_ids.shape
    W = arena["cell"].shape[1]
    cap = arena["kind"].shape[1] - 1
    dev = class_ids.device
    lay = _block_layout(tables, W, epsilon, cap)
    start = kref.lane_vector(start, B, dev).to(torch.int32)
    valid = kref.lane_vector(valid, B, dev, "valid_counts").to(torch.int32)
    gpos = gpos.to(torch.int32)
    kw = dict(lay=lay, ptab=_ptab(tables, dev), finals_sq=_finals(tables, dev),
              expire=expire, consume=consume, impl=impl)
    cells0, sstart0 = chunk_cells(arena)
    if n_seg == 1:
        roots = ops.arena_store_update(arena, cells0, sstart0, class_ids,
                                       hits, gpos, start, valid, **kw)
        return arena, roots
    cells_T, rec_valid, rec_left, rec_right, roots_v = \
        ops.arena_block_update(cells0, class_ids, hits, start, valid,
                               n_seg=n_seg, **kw)
    return _arena_translate_store(arena, lay, cells_T, rec_valid, rec_left,
                                  rec_right, roots_v, gpos, start, valid,
                                  sstart0, hits)


def _arena_translate_store(arena, lay, cells_T, rec_valid, rec_left,
                           rec_right, roots_v, gpos, start, valid, sstart0,
                           hits):
    """The segmented route of :func:`arena_scan_block` after the builder:
    bump allocation by one chunk-level cumsum over the record-validity
    mask, virtual-id translation (overflowing lanes clamp into the sink)
    and one batched update per store field — each store id binary-searches
    its source slot (``torch.searchsorted``) and gathers its record;
    ``kind``/``pos``/``maxs`` decode from the static layout and the
    closed-form slot-start table.  In place."""
    T, B = gpos.shape
    W = lay.W
    M, Q = lay.M, lay.Q
    cap = lay.cap
    dev = gpos.device
    N = T * M

    def flat(r):                   # (T, B, n) → (B, T·n)
        return r.movedim(1, 0).reshape(B, -1)

    # -- 2. bump allocation: one chunk-level cumsum over all T·M slots -----
    need = flat(rec_valid)
    csum = torch.cumsum(need, dim=1, dtype=torch.int32)
    ptr0 = arena["ptr"].clone()
    total = csum[:, -1]
    base = ptr0[:, None] + (csum - need)                      # (B, N)
    voff = lay.voffset

    def tr(v):                     # (B, n) int32 with virtual references
        g = torch.gather(base, 1, (v - voff).clamp(0, N - 1).long())
        return torch.where(v >= voff, g.clamp(max=cap), v)

    # -- 3. batched store update: binary-search source slot, gather record -
    ids_rel = (torch.arange(cap + 1, dtype=torch.int32, device=dev)[None, :]
               - ptr0[:, None]).contiguous()                  # (B, cap+1)
    written = (ids_rel >= 0) & (ids_rel < total[:, None])
    src = torch.searchsorted(csum, ids_rel, right=True).clamp(0, N - 1)
    slot_m = src % M
    t_of = src // M
    kind_new = torch.from_numpy(lay.kind_static()).to(dev)[slot_m]
    gpos_src = torch.gather(gpos.movedim(1, 0), 1, t_of)
    pos_new = torch.where(
        torch.from_numpy(lay.pos_is_event()).to(dev)[slot_m], gpos_src,
        NULL)
    sstart_tr = kref.arena_slot_starts(sstart0, gpos, start, valid, W=W)
    d_m = torch.from_numpy(lay.d_static()).to(dev)[slot_m]
    w_m = torch.where(d_m >= 0, (start[:, None] + t_of - d_m) % W,
                      torch.from_numpy(lay.w_static()).to(dev)[slot_m])
    maxs_new = torch.gather(sstart_tr.movedim(1, 0).reshape(B, T * W), 1,
                            t_of * W + w_m)
    maxs_new = torch.where(kind_new == BOTTOM, gpos_src, maxs_new)
    for name, val in (("kind", kind_new), ("pos", pos_new),
                      ("maxs", maxs_new),
                      ("left", tr(torch.gather(flat(rec_left), 1, src))),
                      ("right", tr(torch.gather(flat(rec_right), 1, src)))):
        arena[name].copy_(torch.where(written, val, arena[name]))
    new_ptr = ptr0 + total
    arena["ovf"] |= new_ptr > cap
    arena["ptr"].copy_(new_ptr.clamp(max=cap))
    arena["cell"].copy_(tr(cells_T[0].reshape(B, -1)).reshape(
        arena["cell"].shape))
    roots = tr(flat(roots_v)).reshape(B, T, Q).movedim(0, 1)
    return arena, torch.where(torch.as_tensor(hits, device=dev).bool(),
                              roots, NULL)


# ---------------------------------------------------------------------------
# shared chunk step + one-shot driver
# ---------------------------------------------------------------------------


def window_expire_masks(window: "wkern.DeviceWindow", ts_ring0, event_ts,
                        start, valid) -> torch.Tensor:
    """(T, B, W) bool time-eviction masks, in closed form.

    Seeding is position-driven in both window modes, so the per-slot start
    timestamp at every step decodes without a recurrence
    (:func:`repro_torch.kernels.ref.arena_slot_starts` fed with
    timestamps); slot ``w`` expires at step ``t`` when it falls below
    ``τ_t − size``, computed in f32 as the counting kernels do.
    """
    event_ts = torch.as_tensor(event_ts, dtype=torch.float32)
    slot_ts = kref.arena_slot_starts(ts_ring0, event_ts, start, valid,
                                     W=window.ring)
    bound = event_ts - torch.tensor(window.size, dtype=torch.float32,
                                    device=event_ts.device)
    return slot_ts < bound[:, :, None]


def run_arena_scan(atables: ArenaTables, arena: dict, trace, gpos, start,
                   valid, hits, *, epsilon: int, expire=None, consume=None,
                   arena_impl: str = "block", impl: str = "fused"):
    """Dispatch one arena chunk: ``arena_impl="block"`` (the builder kernel
    route, default) or ``"fold"`` (the per-event reference fold)."""
    check_arena_impl(arena_impl)
    if arena_impl == "fold":
        return arena_scan(atables, arena, trace, gpos, start, valid, hits,
                          epsilon=epsilon, expire=expire, consume=consume)
    return arena_scan_block(atables, arena, trace, gpos, start, valid, hits,
                            epsilon=epsilon, expire=expire, consume=consume,
                            impl=impl)


def scan_chunk(atables: ArenaTables, arena: dict, attrs, state, *,
               specs, class_of, class_ind, m_all, finals_q, init_mask,
               window: "wkern.DeviceWindow", start: int, gbase: int, impl,
               arena_impl: str = "block", event_ts=None, latest_q=None,
               consume_sq=None, inplace: bool = False):
    """One chunk through the counting pipeline and the arena, every lane at
    ring offset ``start`` and global positions ``gbase + t``.

    The counting pipeline returns the class trace the arena consumes; time
    windows derive the same eviction masks for the arena cells; CONSUME BY
    ANY derives the per-step cell-clear masks from the emitted matches.
    ``inplace`` updates ``state``'s tensors (the streaming engine's
    buffers).  Returns ``(matches, state', arena', roots)``.
    """
    from ..kernels import ops
    ts_ring0 = state["ts"].clone() if window.is_time else None
    matches, state, trace = ops.cer_pipeline(
        attrs, specs, class_of, class_ind, m_all, finals_q, state,
        init_mask=init_mask, window=window, event_ts=event_ts,
        start_pos=start, impl=impl, return_trace=True, latest_q=latest_q,
        consume_sq=consume_sq, inplace=inplace)
    T, B = trace.shape
    dev = trace.device
    gpos = (gbase + torch.arange(T, dtype=torch.int32, device=dev)
            )[:, None].expand(T, B)
    start_b = torch.full((B,), int(start), dtype=torch.int32, device=dev)
    valid_b = torch.full((B,), T, dtype=torch.int32, device=dev)
    expire = (window_expire_masks(window, ts_ring0, event_ts, start_b,
                                  valid_b) if window.is_time else None)
    # the arena runs on live dims (Q queries, S states)
    hits = (matches > 0.5)[..., :atables.num_queries]
    consume = None
    if consume_sq is not None:
        csq = consume_sq.to(torch.float32)[:atables.num_queries,
                                           :atables.num_states]
        consume = torch.einsum("tbq,qs->tbs", hits.to(torch.float32),
                               csq) > 0.5
    arena, roots = run_arena_scan(
        atables, arena, trace, gpos, start_b, valid_b, hits,
        epsilon=window.epsilon, expire=expire, consume=consume,
        arena_impl=arena_impl, impl=impl)
    return matches, state, arena, roots


def resolve_enum_strategy(engine, strategy):
    """Resolve ``run_enumerate``'s strategy against the engine's compiled
    semantics: the post-filter strategy, or ``None`` for native
    enumeration.  An explicit strategy on a natively-compiled engine must
    be the engine's own; anything else would double-filter, so it raises.
    """
    if strategy is None:
        return None
    if not getattr(engine, "native_semantics", False):
        return strategy
    strats = getattr(engine, "strategies", ())
    if all(s == strategy for s in strats):
        return None
    raise ValueError(
        f"engine compiled native semantics {tuple(strats)!r}; cannot "
        f"post-filter its enumeration under {strategy!r} — construct the "
        "engine from a query with that strategy instead")


def take_latest_group(ces) -> List[ComplexEvent]:
    """First (latest-start) group of an arena enumeration, O(group): the
    root chains starts in decreasing order, so Algorithm 2 yields all
    complex events of the latest start first — a LAST query's matches."""
    it = iter(ces)
    first = next(it, None)
    if first is None:
        return []
    out = [first]
    for ce in it:
        if int(ce.start) != int(first.start):
            break
        out.append(ce)
    return out


def run_enumerate(engine, streams, start_pos: int = 0,
                  arena_capacity: int = 1 << 15, strategy=None):
    """One-shot pipeline, arena and enumeration over pre-batched streams.

    ``engine`` is a constructed :class:`~repro_torch.vector.engine.
    VectorEngine` or a packed :class:`~repro_torch.vector.multiquery.
    MultiQueryEngine`.  The counting pipeline and the arena run on the engine's
    device; the host then fetches the arena and walks Algorithm 2 per hit.
    ``strategy=None`` enumerates under the query's compiled semantics (LAST
    takes the latest-start group, capped by its count).  Returns ``(counts
    (T, B, Q) int64, {(t, b, q): [ComplexEvent]})``.
    """
    from ..core.selection import apply_strategy
    post = resolve_enum_strategy(engine, strategy)
    attrs, event_ts = engine.encode_ts(streams, base_pos=int(start_pos))
    tbl = engine.tables
    finals_q = tbl.finals if tbl.finals.ndim == 2 else tbl.finals[None, :]
    atables = engine.arena_tables()
    T, B = attrs.shape[:2]
    arena = init_arena(B, arena_capacity, engine.ring, atables.num_states,
                       device=engine.device)
    matches_f, _, arena, roots = scan_chunk(
        atables, arena, attrs, engine.init_state(B),
        specs=engine.encoder.specs, class_of=tbl.class_of,
        class_ind=tbl.class_ind, m_all=tbl.m_all, finals_q=finals_q,
        init_mask=tbl.init_mask, window=engine.window, start=int(start_pos),
        gbase=int(start_pos), impl=engine.impl,
        arena_impl=getattr(engine, "arena_impl", "block"),
        event_ts=event_ts, latest_q=tbl.latest_q,
        consume_sq=tbl.consume_sq)
    counts = matches_f.cpu().numpy().astype(np.int64)
    roots_np = roots.cpu().numpy()
    latest_np = (tbl.latest_q.cpu().numpy() > 0.5
                 if tbl.latest_q is not None else None)
    snap = ArenaSnapshot(arena)
    tbq = list(zip(*np.nonzero(counts)))
    js = [int(start_pos) + int(t) for t, b, q in tbq]
    caps = ([int(counts[t, b, q]) if latest_np[q] else _NO_CAP
             for t, b, q in tbq] if latest_np is not None else None)
    batches = snap.enumerate_batch(
        [int(b) for t, b, q in tbq],
        [int(roots_np[t, b, q]) for t, b, q in tbq],
        js, [j - engine.epsilon for j in js], caps=caps)
    out = {}
    for (t, b, q), ces in zip(tbq, batches):
        if post is not None:
            ces = apply_strategy(post, ces)
        out[(int(t), int(b), int(q))] = ces
    return counts, out


# ---------------------------------------------------------------------------
# host side: fetch + enumerate (Algorithm 2 over the fetched arrays)
# ---------------------------------------------------------------------------


class ArenaOverflow(RuntimeError):
    """A lane's bump pointer passed capacity; its nodes are unreliable."""


class ArenaSnapshot:
    """Host (numpy) copy of the device arena's node store.

    Node ids are stable across feeds (the store is append-only between
    resets), so roots recorded at earlier chunks stay enumerable from any
    later snapshot — fetch once, enumerate many.
    """

    def __init__(self, arena: dict):
        for name in _NODE_FIELDS + ("ptr", "ovf"):
            setattr(self, name, arena[name].cpu().numpy().copy())

    @classmethod
    def from_mirror(cls, bufs: dict, ptr: np.ndarray, ovf: np.ndarray
                    ) -> "ArenaSnapshot":
        """Snapshot over a mirror's persistent buffers (no copy): a later
        sync only writes rows at or beyond this snapshot's ``ptr`` (or
        rewrites fetched rows with identical values)."""
        snap = cls.__new__(cls)
        for name in _NODE_FIELDS:
            setattr(snap, name, bufs[name])
        snap.ptr = ptr
        snap.ovf = ovf
        return snap

    @property
    def nodes_created(self) -> int:
        return int(self.ptr.sum())

    def _refuse(self, lane: int) -> None:
        raise ArenaOverflow(
            f"lane {lane} overflowed its arena (capacity "
            f"{self.kind.shape[1] - 1}); raise arena_capacity or reset")

    def enumerate(self, lane: int, root: int, end_pos: int,
                  threshold: Optional[int] = None,
                  steps: Optional[List[int]] = None
                  ) -> Iterator[ComplexEvent]:
        """Enumerate ``⟦root⟧(end_pos)`` with output-linear delay.

        ``threshold`` is the earliest admissible start (``None`` disables
        the prune); ``steps`` an optional 1-element node-visit counter.
        """
        if bool(self.ovf[lane]):
            self._refuse(lane)
        yield from enumerate_arena(
            self.kind[lane], self.pos[lane], self.maxs[lane],
            self.left[lane], self.right[lane], int(root), int(end_pos),
            threshold, steps)

    def enumerate_batch(self, lanes: Sequence[int], roots: Sequence[int],
                        ends: Sequence[int],
                        thresholds: Optional[Sequence[int]] = None,
                        caps: Optional[Sequence[int]] = None,
                        steps: Optional[List[int]] = None,
                        oracle: bool = False
                        ) -> List[List[ComplexEvent]]:
        """Frontier-vectorized :meth:`enumerate` over many roots at once.

        One entry per root: its lane, node id (< 0 = empty), end position,
        threshold (None = no prune) and optional match cap.  Returns one
        list per root, equal (order included) to draining the per-root
        DFS, which ``oracle=True`` does instead.
        """
        lanes_a = np.asarray(lanes, dtype=np.int64)
        roots_a = np.asarray(roots, dtype=np.int64)
        live = roots_a >= 0
        if live.any():
            bad = np.unique(lanes_a[live & self.ovf[lanes_a]])
            if bad.size:
                self._refuse(int(bad[0]))
        no_thr = -(1 << 62)
        if thresholds is None:
            thr = np.full(roots_a.shape, no_thr, dtype=np.int64)
        else:
            thr = np.asarray([no_thr if t is None else int(t)
                              for t in thresholds], dtype=np.int64)
        if oracle:
            out: List[List[ComplexEvent]] = []
            for i in range(len(roots_a)):
                if roots_a[i] < 0:
                    out.append([])
                    continue
                it = self.enumerate(
                    int(lanes_a[i]), int(roots_a[i]), int(ends[i]),
                    None if thr[i] == no_thr else int(thr[i]), steps)
                if caps is not None and caps[i] is not None:
                    it = itertools.islice(it, int(caps[i]))
                out.append(list(it))
            return out
        return enumerate_arena_batch(
            self.kind, self.pos, self.maxs, self.left, self.right,
            roots_a, lanes_a, ends, thr, caps=caps, steps=steps)


class ArenaMirror:
    """Persistent host mirror of a device arena with *delta* fetch.

    Node ids are monotone and the store is append-only between resets, so
    successive snapshots differ only in rows ``[fetched : max(ptr))``;
    :meth:`sync` copies just that column span into persistent numpy
    buffers and returns an :class:`ArenaSnapshot` sharing them.  Anything
    that rewrites existing rows (``reset``, ``restore``, regrow) must call
    :meth:`invalidate`.
    """

    def __init__(self):
        self._bufs = None          # name -> (B, cap+1) int32, host
        self._fetched = 0          # columns final in the mirror (min ptr)
        self._shape = None

    def invalidate(self) -> None:
        """Drop the watermark — the next sync refetches from row 0."""
        self._fetched = 0

    @property
    def fetched(self) -> int:
        return self._fetched

    def sync(self, arena: dict) -> ArenaSnapshot:
        """Fetch rows ``[fetched : max(ptr))`` and snapshot the mirror.

        Rows between a lagging lane's ptr and the global max are unwritten
        on the device and may gain nodes later, so the watermark advances
        only to ``min(ptr)``; the skew span is refetched next time.
        """
        ptr = arena["ptr"].cpu().numpy().copy()
        ovf = arena["ovf"].cpu().numpy().copy()
        shape = tuple(arena["kind"].shape)
        if self._bufs is None or self._shape != shape:
            self._bufs = {name: np.full(shape, NULL, np.int32)
                          for name in _NODE_FIELDS}
            self._shape = shape
            self._fetched = 0
        lo, hi = self._fetched, int(ptr.max(initial=0))
        if hi > lo:
            for name in _NODE_FIELDS:
                self._bufs[name][:, lo:hi] = arena[name][:, lo:hi].cpu() \
                    .numpy()
            self._fetched = int(ptr.min(initial=0))
        return ArenaSnapshot.from_mirror(self._bufs, ptr, ovf)


def check_invariants(snap: ArenaSnapshot, lane: int) -> None:
    """Assert the paper's tECS invariants on one lane's node store:
    topologically ordered ids (children < parent), time-ordered unions
    (``max(left) ≥ max(right)``, node max = ``max(left)``), output-depth
    ≤ 3, and positions on bottoms/outputs only."""
    n = int(snap.ptr[lane])
    kind = snap.kind[lane]
    pos, maxs = snap.pos[lane], snap.maxs[lane]
    left, right = snap.left[lane], snap.right[lane]
    odepth = np.zeros(n, np.int64)
    for i in range(n):
        k = kind[i]
        assert k in (BOTTOM, OUTPUT, UNION), (lane, i, k)
        if k == BOTTOM:
            assert left[i] == NULL and right[i] == NULL, (lane, i)
            assert pos[i] == maxs[i] >= 0, (lane, i)
        elif k == OUTPUT:
            assert 0 <= left[i] < i, (lane, i, left[i])
            assert maxs[i] == maxs[left[i]], (lane, i)
        else:
            li, ri = int(left[i]), int(right[i])
            assert 0 <= li < i and 0 <= ri < i, (lane, i, li, ri)
            assert pos[i] == NULL, (lane, i)
            assert maxs[li] >= maxs[ri], (lane, i, maxs[li], maxs[ri])
            assert maxs[i] == maxs[li], (lane, i)
            odepth[i] = 1 + odepth[li]
            assert odepth[i] <= 3, (lane, i, odepth[i])
