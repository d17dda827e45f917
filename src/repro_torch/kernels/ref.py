"""Plain PyTorch versions of the counting pipeline (the kernel's reference).

Everything here is float32 torch on whatever device its inputs lie on.  The
CPU route of :func:`repro_torch.kernels.ops.cer_pipeline` runs it, the CPU
tests hold it against the JAX package, and ``chip_smoke.py`` holds the
Hopper kernel against it on the card.

Shapes and conventions:

* ``attrs``      — ``(N, A)`` or ``(T, B, A)`` f32 encoded event attributes.
* ``bits``       — ``(N,)`` int32 packed predicate bits (bit i ⇔ P_i holds).
* ``C``          — ``(B, W, S)`` f32 run counts by lane, ring slot
                   (``start mod W``) and det state (0 = dead, 1 = initial).
* ``M_all``      — ``(C, S, S)`` f32 counting-semiring transition matrices.
* ``class_ids``  — ``(T, B)`` int32 symbol class per event per lane.

Counts are f32 integers, exact while every partial sum stays below 2^24,
whatever the order of summation — so the kernel and this code agree
bit for bit.

The second half is the block tECS builder (the arena-update kernel's plain
version): int32 node ids and records, so kernel and plain version agree bit
for bit too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.tecs import BOTTOM, OUTPUT, UNION

# op codes shared with the kernel's predicate stage
OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE = range(6)

ARENA_NULL = -1  # empty cell / absent child (shared with vector/tecs_arena)


def bitvector_ref(attrs: torch.Tensor, attr_idx: torch.Tensor,
                  op_code: torch.Tensor, threshold: torch.Tensor
                  ) -> torch.Tensor:
    """(N, A) f32 × k predicate specs → (N,) int32 packed bit-vectors."""
    vals = attrs[:, attr_idx.long()]                           # (N, k)
    thr = threshold[None, :]
    results = torch.stack([vals == thr, vals != thr, vals < thr,
                           vals <= thr, vals > thr, vals >= thr])  # (6,N,k)
    idx = op_code.long()[None, None, :].expand(1, *vals.shape)
    bits = torch.gather(results, 0, idx)[0].to(torch.int32)   # (N, k)
    weights = torch.ones(attr_idx.shape[0], dtype=torch.int32,
                         device=attrs.device) << torch.arange(
        attr_idx.shape[0], dtype=torch.int32, device=attrs.device)
    return (bits * weights[None, :]).sum(dim=1, dtype=torch.int32)


def class_trace_ref(attrs: torch.Tensor, attr_idx: torch.Tensor,
                    op_code: torch.Tensor, threshold: torch.Tensor,
                    class_of: torch.Tensor) -> torch.Tensor:
    """(T, B, A) attrs → (T, B) int32 symbol-class trace."""
    T, B, A = attrs.shape
    bits = bitvector_ref(attrs.reshape(T * B, A), attr_idx, op_code,
                         threshold)
    return class_of[bits.long()].reshape(T, B).to(torch.int32)


# ---------------------------------------------------------------------------
# ring masks
# ---------------------------------------------------------------------------


def ring_masks(j: int, W: int, epsilon: int, device="cpu"):
    """Masks for one position ``j`` shared by all lanes: seed slot
    ``j mod W`` and evict ``(j - ε - 1) mod W`` (Python's sign rule, so
    early negative expire indices wrap onto empty slots).  Returns
    ``(seed, clear)``, both (W,) f32 0/1."""
    arange_w = torch.arange(W, device=device)
    seed = (arange_w == j % W).to(torch.float32)
    expire = (arange_w == (j - epsilon - 1) % W).to(torch.float32)
    return seed, torch.maximum(seed, expire)


def ring_masks_lanes(j: torch.Tensor, W: int, epsilon: int):
    """Per-lane count-window masks for positions ``j`` (B,) int.
    Returns ``(seed, clear)``, both (B, W) f32 0/1."""
    arange_w = torch.arange(W, device=j.device)
    seed = (arange_w[None, :] == (j % W)[:, None]).to(torch.float32)
    expire = (arange_w[None, :]
              == ((j - epsilon - 1) % W)[:, None]).to(torch.float32)
    return seed, torch.maximum(seed, expire)


def ring_masks_time(j: torch.Tensor, ts_t: torch.Tensor,
                    ts_ring: torch.Tensor, W: int, size: float):
    """Per-lane time-window masks.

    Every slot whose start timestamp fell below ``ts_t - size`` (computed in
    f32) is cleared; never-seeded slots hold ``-inf`` and always read
    expired.  Returns ``(seed, clear, seed_b, overflow)``: f32 0/1 masks,
    the bool seed mask, and (B,) bool — the seed slot's previous start was
    still live (more than W live starts).
    """
    arange_w = torch.arange(W, device=j.device)
    seed_b = arange_w[None, :] == (j % W)[:, None]             # (B, W)
    bound = ts_t - torch.tensor(size, dtype=torch.float32,
                                device=ts_t.device)
    expire_b = ts_ring < bound[:, None]
    overflow = (seed_b & ~expire_b).any(dim=1)
    seed = seed_b.to(torch.float32)
    clear = torch.maximum(seed, expire_b.to(torch.float32))
    return seed, clear, seed_b, overflow


# ---------------------------------------------------------------------------
# selection and consumption
# ---------------------------------------------------------------------------


def latest_slot_counts(C2: torch.Tensor, fq: torch.Tensor, j: torch.Tensor,
                       latest_q: torch.Tensor) -> torch.Tensor:
    """Per-query counts with LAST queries reduced to the youngest live slot.

    Slots and seed positions biject inside the window, so LAST's "latest
    start" is the slot with the smallest age ``(j - w) mod W`` among those
    with a positive count.  Ages of one lane are distinct, so that slot is
    unique.  Queries with ``latest_q == 0`` keep the plain sum over slots.

    C2: (B, W, S); fq: (Q, S); j: (B,) int; latest_q: (Q,) f32 0/1.
    Returns (B, Q) f32.
    """
    W = C2.shape[1]
    mw = torch.einsum("bws,qs->bwq", C2, fq)                   # (B, W, Q)
    age = (j[:, None] - torch.arange(W, device=C2.device)[None, :]) % W
    live_age = torch.where(mw > 0, age[:, :, None], W)         # (B, W, Q)
    youngest = live_age.argmin(dim=1, keepdim=True)            # (B, 1, Q)
    m_latest = torch.gather(mw, 1, youngest)[:, 0, :] \
        * (mw > 0).any(dim=1).to(C2.dtype)
    m_sum = mw.sum(dim=1)
    lq = latest_q.to(C2.dtype)[None, :]
    return m_sum * (1.0 - lq) + m_latest * lq


def consume_clear(C2: torch.Tensor, m: torch.Tensor,
                  consume_sq: torch.Tensor) -> torch.Tensor:
    """CONSUME BY ANY's emit-then-clear: any query with a positive
    (live-masked) count zeroes the ring over the states it owns, including
    the run seeded this step.  C2: (B, W, S); m: (B, Q); consume_sq: (Q, S).
    """
    trig = (m > 0).to(C2.dtype)                                # (B, Q)
    clear_s = torch.clamp(trig @ consume_sq.to(C2.dtype), max=1.0)
    return C2 * (1.0 - clear_s)[:, None, :]


# ---------------------------------------------------------------------------
# the windowed scan
# ---------------------------------------------------------------------------


def class_rows(M_all: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``M_all[ids]`` as the reference's gather takes it: a negative id
    counts from the end (adds C), then the id clamps into [0, C−1]."""
    C = M_all.shape[0]
    ids = ids.long()
    return M_all[torch.where(ids < 0, ids + C, ids).clamp(0, C - 1)]


def lane_vector(x, B: int, device, name: str = "start_pos") -> torch.Tensor:
    """Scalar or (B,) per-lane operand → (B,) int64 tensor on ``device``."""
    t = torch.as_tensor(x, device=device).to(torch.int64)
    if t.ndim == 0:
        return t.expand(B)
    if tuple(t.shape) != (B,):
        raise ValueError(f"{name} must be a scalar or ({B},), got "
                         f"{tuple(t.shape)}")
    return t


def cea_scan_multi_ref(C0, M_all: torch.Tensor, class_ids: torch.Tensor,
                       finals_q: torch.Tensor, init_mask: torch.Tensor,
                       epsilon: int, start_pos=0, valid_counts=None,
                       window=None, event_ts=None, latest_q=None,
                       consume_sq=None):
    """Packed multi-query windowed counting scan.

    finals_q: (Q, S) per-query final masks; init_mask: (S,) multi-hot seed.
    ``start_pos`` is a scalar or a (B,) vector of per-lane positions;
    ``valid_counts`` (B,) marks each lane's dense prefix of real events —
    steps ``t ≥ valid[b]`` leave lane ``b`` untouched and emit 0.
    ``latest_q`` (Q,) flags LAST queries, ``consume_sq`` (Q, S) maps
    CONSUME BY ANY queries to the states they clear.

    Count windows take ``C0`` as a (B, W, S) tensor.  Time windows
    (``window.is_time``) take the ``{"C", "ts", "ovf"}`` dict and
    ``event_ts`` (T, B) f32.  Returns ``(state_T, matches (T, B, Q))``.
    """
    if window is not None and window.is_time:
        return _scan_multi_time_ref(C0, M_all, class_ids, finals_q,
                                    init_mask, window.size, start_pos,
                                    valid_counts, event_ts, latest_q,
                                    consume_sq)
    return _scan_multi_count_ref(C0, M_all, class_ids, finals_q, init_mask,
                                 epsilon, start_pos, valid_counts, latest_q,
                                 consume_sq)


def _scan_multi_count_ref(C0, M_all, class_ids, finals_q, init_mask,
                          epsilon: int, start_pos=0, valid_counts=None,
                          latest_q=None, consume_sq=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Count-window scan body: one slot evicted per step."""
    B, W, S = C0.shape
    if W < epsilon + 1:
        raise ValueError(f"ring {W} < epsilon+1 ({epsilon + 1})")
    dev = C0.device
    fq = finals_q.to(C0.dtype)
    im = init_mask.to(C0.dtype)
    start = lane_vector(start_pos, B, dev)
    valid = (None if valid_counts is None
             else lane_vector(valid_counts, B, dev, "valid_counts"))
    C = C0
    out = []
    for t in range(class_ids.shape[0]):
        M = class_rows(M_all, class_ids[t])                    # (B, S, S)
        j = start + t
        seed, clear = ring_masks_lanes(j, W, epsilon)
        C2 = C * (1.0 - clear)[:, :, None] + seed[:, :, None] * im
        C2 = torch.bmm(C2, M)
        if latest_q is None:
            m = torch.einsum("bws,qs->bq", C2, fq)
        else:
            m = latest_slot_counts(C2, fq, j, latest_q)
        if valid is not None:
            live = t < valid                                   # (B,)
            C2 = torch.where(live[:, None, None], C2, C)
            m = m * live[:, None].to(m.dtype)
        if consume_sq is not None:
            C2 = consume_clear(C2, m, consume_sq)
        C = C2
        out.append(m)
    return C, torch.stack(out) if out else C0.new_zeros((0, B, fq.shape[0]))


def _scan_multi_time_ref(C0: dict, M_all, class_ids, finals_q, init_mask,
                         size: float, start_pos=0, valid_counts=None,
                         event_ts=None, latest_q=None, consume_sq=None):
    """Time-window scan body: timestamp-ring eviction and the ovf latch."""
    C, tsr, ovf = C0["C"], C0["ts"], C0["ovf"]
    B, W, S = C.shape
    dev = C.device
    fq = finals_q.to(C.dtype)
    im = init_mask.to(C.dtype)
    start = lane_vector(start_pos, B, dev)
    valid = (None if valid_counts is None
             else lane_vector(valid_counts, B, dev, "valid_counts"))
    ev_ts = torch.as_tensor(event_ts, dtype=torch.float32, device=dev)
    out = []
    for t in range(class_ids.shape[0]):
        M = class_rows(M_all, class_ids[t])
        j = start + t
        ts_t = ev_ts[t]
        seed, clear, seed_b, over = ring_masks_time(j, ts_t, tsr, W, size)
        C2 = C * (1.0 - clear)[:, :, None] + seed[:, :, None] * im
        C2 = torch.bmm(C2, M)
        if latest_q is None:
            m = torch.einsum("bws,qs->bq", C2, fq)
        else:
            m = latest_slot_counts(C2, fq, j, latest_q)
        tsr2 = torch.where(seed_b, ts_t[:, None], tsr)
        if valid is not None:
            live = t < valid
            C2 = torch.where(live[:, None, None], C2, C)
            m = m * live[:, None].to(m.dtype)
            tsr2 = torch.where(live[:, None], tsr2, tsr)
            over = over & live
        if consume_sq is not None:
            C2 = consume_clear(C2, m, consume_sq)
        C, tsr, ovf = C2, tsr2, ovf | over
        out.append(m)
    matches = (torch.stack(out) if out
               else C.new_zeros((0, B, fq.shape[0])))
    return {"C": C, "ts": tsr, "ovf": ovf}, matches


def cea_step_ref(C: torch.Tensor, M: torch.Tensor, seed_slot: int,
                 expire_slot: int, finals: torch.Tensor,
                 init_state: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """One windowed CEA step (Algorithm 1's update, dense form).

    C (B, W, S) run counts; M (B, S, S) this event's transition matrix per
    lane; ``seed_slot`` is ``j mod W``, where a fresh run starts at
    ``init_state``; ``expire_slot`` is the slot of start ``j - ε - 1``,
    which just left the window; finals (S,).  Returns ``(C', matches
    (B,))``.
    """
    B, W, S = C.shape
    arange_w = torch.arange(W, device=C.device)
    clear = (arange_w == seed_slot) | (arange_w == expire_slot)
    C = C * (1.0 - clear.to(C.dtype))[None, :, None]
    seed_oh = (arange_w == seed_slot).to(C.dtype)
    init_oh = (torch.arange(S, device=C.device) == init_state).to(C.dtype)
    C = C + seed_oh[None, :, None] * init_oh[None, None, :]
    C = torch.bmm(C, M)
    matches = torch.einsum("bws,s->b", C, finals.to(C.dtype))
    return C, matches


def cea_scan_ref(C0: torch.Tensor, M_all: torch.Tensor,
                 class_ids: torch.Tensor, finals: torch.Tensor, epsilon: int,
                 start_pos: int = 0, init_state: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-query scan of :func:`cea_step_ref` over T events, window
    ``end - start ≤ ε``, one scalar ``start_pos`` for every lane.

    Requires ring size W ≥ ε+1.  Returns ``(C_T, matches (T, B))``.
    """
    B, W, S = C0.shape
    if W < epsilon + 1:
        raise ValueError(f"ring {W} < epsilon+1 ({epsilon + 1})")
    C = C0
    out = []
    for t in range(class_ids.shape[0]):
        j = int(start_pos) + t
        C, m = cea_step_ref(C, class_rows(M_all, class_ids[t]), j % W,
                            (j - epsilon - 1) % W, finals, init_state)
        out.append(m)
    return C, torch.stack(out) if out else C0.new_zeros((0, B))


# ---------------------------------------------------------------------------
# the unfused pipeline's plain entries (the reference package's ops layout)
# ---------------------------------------------------------------------------


def bitvector(attrs: torch.Tensor,
              specs: Sequence[Tuple[int, int, float]]) -> torch.Tensor:
    """(N, A) f32 × predicate specs ``(column, op, threshold)`` → (N,)
    int32 packed bits; thresholds are rounded to f32 before the compare."""
    dev = attrs.device
    idx = torch.tensor([s[0] for s in specs], dtype=torch.int64, device=dev)
    ops_ = torch.tensor([s[1] for s in specs], dtype=torch.int64, device=dev)
    thr = torch.tensor([s[2] for s in specs], dtype=torch.float32,
                       device=dev)
    return bitvector_ref(attrs, idx, ops_, thr)


def cea_scan(class_ids: torch.Tensor, m_all: torch.Tensor,
             finals: torch.Tensor, c0: torch.Tensor, *, epsilon: int,
             start_pos: int = 0, init_state: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """class_ids (T, B) × finals (S,) × c0 (B, W, S) → (matches (T, B),
    c_final (B, W, S))."""
    c_fin, matches = cea_scan_ref(c0, m_all, class_ids, finals, epsilon,
                                  start_pos=start_pos, init_state=init_state)
    return matches, c_fin


def cea_scan_multi(class_ids: torch.Tensor, m_all: torch.Tensor,
                   finals_q: torch.Tensor, c0: torch.Tensor, *,
                   init_mask: torch.Tensor, epsilon: int, start_pos: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """class_ids (T, B) × finals_q (Q, S) × init_mask (S,) × c0 (B, W, S) →
    (matches (T, B, Q), c_final (B, W, S))."""
    c_fin, matches = cea_scan_multi_ref(c0, m_all, class_ids, finals_q,
                                        init_mask, epsilon,
                                        start_pos=start_pos)
    return matches, c_fin


# ---------------------------------------------------------------------------
# block tECS arena builder
# ---------------------------------------------------------------------------
#
# Per event the builder carries only the (B, W, S) cell table (node id,
# is-union flag, left, right) and emits a fixed layout of M node records on
# *virtual* ids: the node allocated at (event t, layout slot m) has id
# ``voffset + t·M + m`` with ``voffset = capacity + 1``, so virtual ids never
# collide with real store ids.  Real ids follow the validity mask in (event,
# slot) order: :func:`arena_store_ref` ranks each event's mask as it goes and
# writes the store; the segmented route takes one chunk-level cumsum after
# :func:`arena_build_ref` (``vector.tecs_arena._arena_translate_store``).
# Layout slots run over target states that can statically allocate there, in
# the per-event reference fold's allocation order, so node stores come out
# bit-identical to it.


@dataclass(frozen=True)
class ArenaBlockLayout:
    """Static per-event slot layout of the block tECS builder.

    Slot regions, in id order (children always precede parents):

    * ``off_bottom``  — 1 slot: the event's ``new_bottom`` node.
    * ``off_ext[k]``  — W·|ext_states[k]| slots per fold depth k: extend
      nodes of states with a marking predecessor edge at depth k.
    * ``off_uni[k]``  — 3·W·|uni_states[k]| slots per fold depth k ≥ 1: the
      union gadget's up-to-3 nodes per cell (``off_uni[0] = −1``).
    * ``off_fs[fi]``  — 3·W·Q slots per relevant final state after the
      first: the same-slot root fold (−1 for fi = 0).
    * ``off_chain``   — (ε+1)·Q slots: the Fig. 5(e) right-chain, oldest
      start first.
    """

    W: int
    S: int
    K: int
    Q: int
    epsilon: int
    cap: int
    init_states: Tuple[int, ...]
    fin_states: Tuple[int, ...]
    ext_states: Tuple[Tuple[int, ...], ...]
    uni_states: Tuple[Tuple[int, ...], ...]
    off_bottom: int
    off_ext: Tuple[int, ...]
    off_uni: Tuple[int, ...]
    off_fs: Tuple[int, ...]
    off_chain: int
    M: int

    @property
    def E(self) -> int:
        return self.epsilon + 1

    @property
    def voffset(self) -> int:
        """First virtual id (one past the store's sink slot)."""
        return self.cap + 1

    def _region_tables(self):
        """(kind, w_of, d_of) static (M,) int32 decode tables (cached)."""
        cached = getattr(self, "_tables_cache", None)
        if cached is not None:
            return cached
        kind = np.full(self.M, UNION, np.int32)
        w_of = np.zeros(self.M, np.int32)
        d_of = np.full(self.M, -1, np.int32)
        kind[self.off_bottom] = BOTTOM
        for k, off in enumerate(self.off_ext):
            n = len(self.ext_states[k])
            kind[off:off + self.W * n] = OUTPUT
            w_of[off:off + self.W * n] = np.repeat(np.arange(self.W), n)
        for k, off in enumerate(self.off_uni):
            if off >= 0:
                n = len(self.uni_states[k])
                w_of[off:off + 3 * self.W * n] = np.repeat(
                    np.arange(self.W), 3 * n)
        for off in self.off_fs:
            if off >= 0:
                w_of[off:off + 3 * self.W * self.Q] = np.repeat(
                    np.arange(self.W), 3 * self.Q)
        # chain slots: the ring slot is (j − d) mod W; record d instead
        d_of[self.off_chain:self.off_chain + self.E * self.Q] = np.repeat(
            np.arange(self.epsilon, -1, -1), self.Q)
        object.__setattr__(self, "_tables_cache", (kind, w_of, d_of))
        return kind, w_of, d_of

    def kind_static(self) -> np.ndarray:
        """(M,) int32 node kind per slot."""
        return self._region_tables()[0]

    def pos_is_event(self) -> np.ndarray:
        """(M,) bool — slots whose ``pos`` label is the event position."""
        return self.kind_static() != UNION

    def w_static(self) -> np.ndarray:
        """(M,) int32 ring slot per layout slot (chain slots: d_static)."""
        return self._region_tables()[1]

    def d_static(self) -> np.ndarray:
        """(M,) int32 chain age d (slot = (j−d) mod W); −1 off-chain."""
        return self._region_tables()[2]

    def state_ranks(self) -> Tuple[np.ndarray, np.ndarray]:
        """(K, S) int32 rank of each state in ``ext_states[k]`` and
        ``uni_states[k]`` (−1 where absent)."""
        ext = np.full((self.K, self.S), -1, np.int32)
        uni = np.full((self.K, self.S), -1, np.int32)
        for k in range(self.K):
            for r, s in enumerate(self.ext_states[k]):
                ext[k, s] = r
            for r, s in enumerate(self.uni_states[k]):
                uni[k, s] = r
        return ext, uni


def arena_block_layout(W: int, S: int, K: int, Q: int, epsilon: int,
                       cap: int, init_states, finals_sq_np,
                       pred_mark_np, pred_valid_np) -> ArenaBlockLayout:
    """The static slot layout for one (query tables, ring, capacity).

    ``pred_mark_np``/``pred_valid_np``: the (C, S, K) predecessor tables,
    which decide which target states can allocate at each fold depth.
    """
    fin = tuple(int(s) for s in range(S)
                if np.asarray(finals_sq_np)[s].any())
    pm = np.asarray(pred_mark_np).astype(bool)
    pv = np.asarray(pred_valid_np).astype(bool)
    ext_states = tuple(
        tuple(int(s) for s in range(S) if (pv[:, s, k] & pm[:, s, k]).any())
        for k in range(K))
    uni_states = tuple(
        () if k == 0 else tuple(int(s) for s in range(S) if pv[:, s, k].any())
        for k in range(K))
    off = 1                         # slot 0: the bottom node
    off_ext: List[int] = []
    off_uni: List[int] = []
    for k in range(K):
        off_ext.append(off)
        off += W * len(ext_states[k])
        if k == 0:
            off_uni.append(-1)
        else:
            off_uni.append(off)
            off += 3 * W * len(uni_states[k])
    off_fs: List[int] = []
    for fi in range(len(fin)):
        if fi == 0:
            off_fs.append(-1)
        else:
            off_fs.append(off)
            off += 3 * W * Q
    off_chain = off
    off += (epsilon + 1) * Q
    return ArenaBlockLayout(
        W=W, S=S, K=K, Q=Q, epsilon=epsilon, cap=cap,
        init_states=tuple(int(s) for s in init_states), fin_states=fin,
        ext_states=ext_states, uni_states=uni_states, off_bottom=0,
        off_ext=tuple(off_ext), off_uni=tuple(off_uni),
        off_fs=tuple(off_fs), off_chain=off_chain, M=off)


def pack_pred_tables(pred_idx, pred_mark, pred_valid) -> np.ndarray:
    """Stack the three (C, S, K) predecessor tables → (C, S, K, 3) int32."""
    return np.stack([np.asarray(pred_idx).astype(np.int32),
                     np.asarray(pred_mark).astype(np.int32),
                     np.asarray(pred_valid).astype(np.int32)], axis=-1)


def _union_gadget(acc, contrib, cval, v0):
    """One vectorized application of the paper's union gadgets (Fig. 5 a–d).

    acc/contrib: ``(id, is_union, left, right)`` int32 tensors; cval: bool
    where ``contrib`` participates; v0: virtual id of the gadget's first
    slot (slots v0, v0+1, v0+2).  All participants share the cell's
    max-start, so no time-order comparison is needed.

    Returns ``(acc', records)``, records = ``(valid0, left0, right0,
    valid12, left1, right1, left2, right2)``: slot 0 carries the pairwise
    union (cases a/b) or the spliced ``u2`` (c/d); slots 1–2 carry
    ``u1``/``u`` of the union×union splice.
    """
    a_id, a_u, a_l, a_r = acc
    c_id, c_u, c_l, c_r = contrib
    prev = a_id != ARENA_NULL
    do_u = cval & prev
    both = do_u & (a_u > 0) & (c_u > 0)
    single = do_u & ~both
    case_a = single & (a_u == 0)      # (a): acc non-union → left = acc
    l1 = torch.where(case_a, a_id, c_id)
    r1 = torch.where(case_a, c_id, a_id)
    rec0_l = torch.where(single, l1, a_r)
    rec0_r = torch.where(single, r1, c_r)
    n_id = torch.where(do_u, torch.where(both, v0 + 2, v0),
                       torch.where(cval, c_id, a_id))
    n_u = torch.where(do_u, torch.ones_like(a_u),
                      torch.where(cval & ~prev, c_u, a_u))
    n_l = torch.where(do_u, torch.where(both, a_l, l1),
                      torch.where(cval, c_l, a_l))
    n_r = torch.where(do_u, torch.where(both, v0 + 1, r1),
                      torch.where(cval, c_r, a_r))
    records = (do_u, rec0_l, rec0_r, both, c_l, v0, a_l, v0 + 1)
    return (n_id, n_u, n_l, n_r), records


def _consts(lay: ArenaBlockLayout, device) -> dict:
    """Per-device index tensors of a layout (cached on it)."""
    cache = getattr(lay, "_consts_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(lay, "_consts_cache", cache)
    key = str(device)
    if key not in cache:
        rank_ext, rank_uni = lay.state_ranks()

        def idx(states):
            return torch.tensor(states, dtype=torch.long, device=device)

        init_oh = torch.zeros(lay.S, dtype=torch.bool, device=device)
        init_oh[list(lay.init_states)] = True
        i32 = dict(dtype=torch.int32, device=device)
        cache[key] = {
            "rank_ext": torch.from_numpy(rank_ext).to(device),
            "rank_uni": torch.from_numpy(rank_uni).to(device),
            "ext_idx": [idx(s) for s in lay.ext_states],
            "uni_idx": [idx(s) for s in lay.uni_states],
            "init_oh": init_oh,
            "iota_w": torch.arange(lay.W, **i32),
            "iota_e": torch.arange(lay.E, **i32),
            "iota_q": torch.arange(lay.Q, **i32),
            "fs_ix": torch.arange(lay.W * lay.Q, **i32).reshape(lay.W,
                                                                 lay.Q),
        }
    return cache[key]


def _tri(a, b, c, idx, B: int):
    """Three (B, W, n)-broadcastable slot arrays, restricted to the states
    ``idx`` → (B, W·n·3) in w-major, state, slot 0/1/2 order."""
    shape = (B,) + tuple(torch.broadcast_shapes(a.shape, b.shape,
                                                c.shape)[1:])
    parts = [torch.broadcast_to(x, shape) for x in (a, b, c)]
    if idx is not None:
        parts = [x[:, :, idx] for x in parts]
    return torch.stack(parts, dim=-1).reshape(B, -1)


def _clear_seed(cells, j, live, vbase, *, lay: ArenaBlockLayout,
                expire_t=None):
    """Ring maintenance for one event: expire, then seed ``new_bottom(j)``.

    cells: ``(cid, cisU, cleft, cright)`` (B, W, S) int32; j/vbase: (B,)
    int32; live: (B,) bool.  ``expire_t`` ((B, W), optional) replaces the
    count-window single-slot rule with a precomputed time-eviction mask.
    Only the id (and, at seeded cells, the is-union flag) change.
    """
    cid, cisU, cleft, cright = cells
    W = lay.W
    cst = _consts(lay, cid.device)
    arange_w = cst["iota_w"]
    seed = (arange_w[None, :] == (j % W)[:, None]) & live[:, None]
    if expire_t is None:
        expire = (arange_w[None, :]
                  == ((j - lay.epsilon - 1) % W)[:, None]) & live[:, None]
    else:
        expire = (expire_t > 0) & live[:, None]
    cid = torch.where((seed | expire)[:, :, None], ARENA_NULL, cid)
    seed_cells = seed[:, :, None] & cst["init_oh"][None, None, :]
    cid = torch.where(seed_cells, (vbase + lay.off_bottom)[:, None, None],
                      cid)
    cisU = torch.where(seed_cells, 0, cisU)
    return cid, cisU, cleft, cright


def _fold_cells(cells_in, cls_t, live, vbase, *, lay: ArenaBlockLayout,
                ptab: torch.Tensor):
    """The predecessor folds of one event: the new cell table and the
    record pieces of the extend and union regions.

    Returns ``(acc, pieces)``: acc the post-fold ``(id, isU, left, right)``;
    pieces the slot-ordered region records, ``(valid, left)`` for extend
    regions (their right child is NULL) and ``(valid, left, right)`` for
    union regions, each (B, region size) int32.
    """
    cid_in, cisU_in, cleft, cright = cells_in
    B, W, S = cid_in.shape
    cst = _consts(lay, cid_in.device)
    pt = ptab[cls_t.long()]                                # (B, S, K, 3)
    iota_w = cst["iota_w"]
    rank_ext, rank_uni = cst["rank_ext"], cst["rank_uni"]
    pieces = []
    acc = None
    for k in range(lay.K):
        idx = pt[:, :, k, 0].clamp(0, S - 1).long()[:, None, :].expand(
            B, W, S)
        src_id, src_u, src_l, src_r = (torch.gather(x, 2, idx) for x in
                                       (cid_in, cisU_in, cleft, cright))
        mk = pt[:, None, :, k, 1] > 0
        cval = ((pt[:, None, :, k, 2] > 0) & (src_id != ARENA_NULL)
                & live[:, None, None])                     # (B, W, S)
        m_ext = cval & mk
        e_idx = cst["ext_idx"][k]
        n_e = len(lay.ext_states[k])
        v_ext = (vbase[:, None, None] + lay.off_ext[k]
                 + iota_w[None, :, None] * n_e + rank_ext[k][None, None, :])
        pieces.append((m_ext[:, :, e_idx].to(torch.int32).reshape(B, -1),
                       src_id[:, :, e_idx].reshape(B, -1)))
        contrib = (torch.where(m_ext, v_ext, src_id),
                   torch.where(cval & ~mk, src_u, 0), src_l, src_r)
        if acc is None:
            acc = (torch.where(cval, contrib[0], ARENA_NULL),
                   torch.where(cval, contrib[1], 0),
                   torch.where(cval, contrib[2], ARENA_NULL),
                   torch.where(cval, contrib[3], ARENA_NULL))
            continue
        u_idx = cst["uni_idx"][k]
        n_u = len(lay.uni_states[k])
        v0 = (vbase[:, None, None] + lay.off_uni[k]
              + 3 * (iota_w[None, :, None] * n_u
                     + rank_uni[k][None, None, :]))
        acc, (v_do, l0, r0, v_both, l1, r1, l2, r2) = _union_gadget(
            acc, contrib, cval, v0)
        vb_i = v_both.to(torch.int32)
        pieces.append((_tri(v_do.to(torch.int32), vb_i, vb_i, u_idx, B),
                       _tri(l0, l1, l2, u_idx, B),
                       _tri(r0, r1, r2, u_idx, B)))
    return acc, pieces


def _roots_step(cells_t, hit_t, j, vbase, *, lay: ArenaBlockLayout,
                finals_sq: torch.Tensor):
    """Root construction for one event from the POST-event cell table:
    same-slot final cells fold through the union gadgets, then slots chain
    right-wards in decreasing start order (Fig. 5(e)).  ``hit_t`` (B, Q)
    bool gates everything.  Returns (pieces, root (B, Q))."""
    cid, cisU, cleft, cright = cells_t
    B, W, S = cid.shape
    Q = lay.Q
    dev = cid.device
    cst = _consts(lay, dev)
    pieces = []
    sa = None
    fs_ix = cst["fs_ix"]
    for fi, s_f in enumerate(lay.fin_states):
        cval = ((cid[:, :, s_f] != ARENA_NULL)[:, :, None]
                & (finals_sq[s_f][None, None, :] > 0)
                & hit_t[:, None, :])                       # (B, W, Q)
        contrib = tuple(c[:, :, s_f][:, :, None].expand(B, W, Q)
                        for c in (cid, cisU, cleft, cright))
        if sa is None:
            sa = (torch.where(cval, contrib[0], ARENA_NULL),
                  torch.where(cval, contrib[1], 0),
                  torch.where(cval, contrib[2], ARENA_NULL),
                  torch.where(cval, contrib[3], ARENA_NULL))
            continue
        v0 = vbase[:, None, None] + lay.off_fs[fi] + 3 * fs_ix[None]
        sa, (v_do, l0, r0, v_both, l1, r1, l2, r2) = _union_gadget(
            sa, contrib, cval, v0)
        vb_i = v_both.to(torch.int32)
        pieces.append((_tri(v_do.to(torch.int32), vb_i, vb_i, None, B),
                       _tri(l0, l1, l2, None, B), _tri(r0, r1, r2, None, B)))
    if sa is None:                 # no final state at all: no roots ever
        sa = (torch.full((B, W, Q), ARENA_NULL, dtype=torch.int32,
                         device=dev),)

    # right-chain over slots in decreasing start order (oldest first)
    E = lay.E
    iota_e = cst["iota_e"]
    slot_d = (j[:, None] - (lay.epsilon - iota_e)[None, :]) % W   # (B, E)
    m_id = torch.gather(sa[0], 1,
                        slot_d.long()[:, :, None].expand(B, E, Q))
    m_val = m_id != ARENA_NULL
    rank = torch.cumsum(m_val.to(torch.int32), dim=1, dtype=torch.int32)
    v_chain = (vbase[:, None, None] + lay.off_chain
               + (iota_e[:, None] * Q + cst["iota_q"][None, :])[None])
    alloc = m_val & (rank >= 2)
    elem = torch.where(m_val, torch.where(alloc, v_chain, m_id), ARENA_NULL)
    pos_e = torch.where(m_val, iota_e[None, :, None], -1)
    last = torch.cummax(pos_e, dim=1).values
    prev_pos = torch.cat([torch.full((B, 1, Q), -1, dtype=last.dtype,
                                     device=dev), last[:, :-1]], dim=1)
    prev_elem = torch.gather(elem, 1, prev_pos.clamp(0, E - 1).long())
    prev_elem = torch.where(prev_pos >= 0, prev_elem, ARENA_NULL)
    pieces.append((alloc.to(torch.int32).reshape(B, -1), m_id.reshape(B, -1),
                   prev_elem.reshape(B, -1)))
    root = torch.gather(elem, 1, last[:, -1:].clamp(0, E - 1).long())[:, 0]
    root = torch.where(last[:, -1] >= 0, root, ARENA_NULL)        # (B, Q)
    return pieces, root


def arena_block_step(cells, cls_t, hit_t, j, live, vbase, *,
                     lay: ArenaBlockLayout, ptab: torch.Tensor,
                     finals_sq: torch.Tensor, expire_t=None, consume_t=None):
    """One event of the block builder: recurrence and record emission.

    cells: four (B, W, S) int32 tensors (id / is-union / left / right).
    cls_t/j/vbase: (B,) int32; hit_t: (B, Q); live: (B,) bool.
    ``expire_t`` ((B, W), optional): time-eviction mask.  ``consume_t``
    ((B, S), optional): CONSUME BY ANY clear, applied to the ids after the
    event's roots.  Returns ``(cells', (valid, left, right), root)`` with
    the record rows (B, M) in slot-layout order and root (B, Q).

    A lane's dead step (``live`` false) leaves its cells, emits no record
    and a NULL root, whatever ``hit_t`` says — the counting scan never
    reports a hit there.  Records are canonical: ``left``/``right`` are
    NULL wherever ``valid`` is 0.
    """
    B = cls_t.shape[0]
    cells_in = _clear_seed(cells, j, live, vbase, lay=lay,
                           expire_t=expire_t)
    acc, pieces = _fold_cells(cells_in, cls_t, live, vbase, lay=lay,
                              ptab=ptab)
    lv = live[:, None, None]
    out = tuple(torch.where(lv, a, c) for a, c in zip(acc, cells_in))
    root_pieces, root = _roots_step(out, (hit_t > 0) & live[:, None], j,
                                    vbase, lay=lay, finals_sq=finals_sq)
    if consume_t is not None:
        clr = (consume_t > 0) & live[:, None]                  # (B, S)
        out = (torch.where(clr[:, None, :], ARENA_NULL, out[0]),) + out[1:]
    all_pieces = pieces + list(root_pieces)
    nullcol = torch.full((B, 1), ARENA_NULL, dtype=torch.int32,
                         device=cls_t.device)
    valid = torch.cat([live.to(torch.int32)[:, None]]
                      + [p[0] for p in all_pieces], dim=1)
    left = torch.cat([nullcol] + [p[1] for p in all_pieces], dim=1)
    right = torch.cat([nullcol] + [p[2] if len(p) == 3
                                   else torch.full_like(p[1], ARENA_NULL)
                                   for p in all_pieces], dim=1)
    ok = valid > 0
    left = torch.where(ok, left, ARENA_NULL)
    right = torch.where(ok, right, ARENA_NULL)
    return out, (valid, left, right), root


def pick_segments(T: int, W: int, max_seg: int = 8) -> int:
    """Number of parallel chunk segments: the largest n ≤ ``max_seg`` with
    n | T and T/n ≥ W (segment replays never leave the chunk), else 1."""
    best = 1
    for n in range(2, max_seg + 1):
        if T % n == 0 and T // n >= W:
            best = n
    return best


def segment_operands(cells0, class_ids, hits, start, valid_counts, *,
                     lay: ArenaBlockLayout, n_seg: int, expire=None,
                     consume=None):
    """The (steps, n_seg·B, …) int32 step operands of segmented execution.

    Segment g owns global steps [g·G, (g+1)·G) and first replays the W
    steps before them from an empty cell table (segment 0 replays into the
    void: those steps are dead and its start cells are ``cells0``).
    Virtual ids depend only on the absolute event index, so replays
    reproduce the handoff state exactly.  Returns ``((cls, hit, j, live,
    vbase[, expire][, consume]), cells0_seg)``, every operand contiguous.
    """
    T, B = class_ids.shape
    W = lay.W
    dev = class_ids.device
    i32 = torch.int32
    hits = torch.as_tensor(hits, device=dev).to(i32)
    start = start.to(i32)
    valid_counts = valid_counts.to(i32)
    if n_seg == 1:
        ts = torch.arange(T, dtype=i32, device=dev)
        j = start[None, :] + ts[:, None]
        live = (ts[:, None] < valid_counts[None, :]).to(i32)
        vb = (lay.voffset + ts * lay.M)[:, None].expand(T, B)
        xs = (class_ids.to(i32), hits, j, live, vb)
        if expire is not None:
            xs = xs + (expire.to(i32),)
        if consume is not None:
            xs = xs + (consume.to(i32),)
        return tuple(x.contiguous() for x in xs), tuple(cells0)
    if T % n_seg or T // n_seg < W:
        raise ValueError(f"n_seg={n_seg} needs n_seg | T and T/n_seg ≥ W "
                         f"(T={T}, W={W})")
    G = T // n_seg
    steps = W + G
    t_idx = (torch.arange(n_seg, dtype=i32, device=dev)[:, None] * G - W
             + torch.arange(steps, dtype=i32, device=dev)[None, :])
    tc = t_idx.clamp(0, T - 1).long()                      # (n_seg, steps)

    def seg(x):                    # (T, B, ...) → (steps, n_seg·B, ...)
        return x[tc].movedim(0, 1).reshape((steps, n_seg * B)
                                           + tuple(x.shape[2:]))

    t_real = t_idx[:, :, None].expand(n_seg, steps, B).movedim(0, 1) \
        .reshape(steps, -1)
    live = ((t_real >= 0)
            & (t_real < valid_counts.repeat(n_seg)[None, :])).to(i32)
    j = start.repeat(n_seg)[None, :] + t_real
    vb = lay.voffset + t_real * lay.M
    cells0_seg = tuple(
        torch.cat([c0] + [torch.full_like(c0, ARENA_NULL)] * (n_seg - 1))
        for c0 in cells0)
    xs = (seg(class_ids.to(i32)), seg(hits), j, live, vb)
    if expire is not None:
        xs = xs + (seg(expire.to(i32)),)
    if consume is not None:
        xs = xs + (seg(consume.to(i32)),)
    return tuple(x.contiguous() for x in xs), cells0_seg


def arena_build_ref(cells0, class_ids, hits, start, valid_counts, *,
                    lay: ArenaBlockLayout, ptab: torch.Tensor,
                    finals_sq: torch.Tensor, n_seg: int = 1, expire=None,
                    consume=None):
    """Block tECS builder over one chunk — the plain PyTorch version.

    cells0: four (B, W, S) int32 tensors (the chunk-start cell table).
    class_ids: (T, B) int32; hits: (T, B, Q); start/valid_counts: (B,).
    ``expire`` ((T, B, W), optional): time-eviction masks; ``consume``
    ((T, B, S), optional): CONSUME BY ANY clear masks.  Returns
    ``(cells_T, valid, left, right, roots)``: the record tensors (T, B, M)
    and roots (T, B, Q) on virtual ids, as views of lane-major
    (B, T, …) storage — the layout the store update reads.
    """
    xs, cells = segment_operands(cells0, class_ids, hits, start,
                                 valid_counts, lay=lay, n_seg=n_seg,
                                 expire=expire, consume=consume)
    steps, Bn = xs[0].shape
    dev = class_ids.device
    recs = (torch.zeros((Bn, steps, lay.M), dtype=torch.int32, device=dev),
            torch.full((Bn, steps, lay.M), ARENA_NULL, dtype=torch.int32,
                       device=dev),
            torch.full((Bn, steps, lay.M), ARENA_NULL, dtype=torch.int32,
                       device=dev))
    roots = torch.full((Bn, steps, lay.Q), ARENA_NULL, dtype=torch.int32,
                       device=dev)
    finals_sq = finals_sq.to(torch.int32)
    for t in range(steps):
        cls_t, hit_t, j, live, vb = (x[t] for x in xs[:5])
        extra = [x[t] for x in xs[5:]]
        exp_t = extra.pop(0) if expire is not None else None
        con_t = extra.pop(0) if consume is not None else None
        cells, rec, root = arena_block_step(
            cells, cls_t, hit_t, j, live > 0, vb, lay=lay, ptab=ptab,
            finals_sq=finals_sq, expire_t=exp_t, consume_t=con_t)
        for buf, r in zip(recs, rec):
            buf[:, t] = r
        roots[:, t] = root
    return assemble_records(cells, tuple(r.movedim(0, 1) for r in recs),
                            roots.movedim(0, 1), *class_ids.shape,
                            lay=lay, n_seg=n_seg)


def arena_store_ref(arena: dict, cells0, sstart0, class_ids, hits, gpos,
                    start, valid_counts, *, lay: ArenaBlockLayout,
                    ptab: torch.Tensor, finals_sq: torch.Tensor, expire=None,
                    consume=None) -> torch.Tensor:
    """Block tECS builder writing the node store directly — the plain
    version of the store kernel.

    arena: the node store dict (``kind/pos/maxs/left/right`` (B, cap+1),
    ``cell`` (B, W, S), ``ptr``, ``ovf``), updated in place.  cells0: the
    chunk-start cell table ``(id, is-union, left, right)`` and sstart0 the
    (B, W) start of each ring slot (``vector.tecs_arena.chunk_cells``).
    class_ids/gpos: (T, B) int32; hits: (T, B, Q); start/valid_counts: (B,)
    int32; expire/consume as in :func:`arena_build_ref`.

    Per step, :func:`arena_block_step` folds on step-local virtual ids
    ``voffset + m``; the exclusive prefix of its validity mask ranks the
    allocated slots, slot m gets the real id ``ptr + rank(m)`` (a
    reference past capacity clamps to the sink ``cap``), and each record
    whose real id is at most ``cap`` lands in the store — so only the one
    landing exactly on ``cap`` writes the sink slot.  ``ptr`` runs on
    unclamped; at the end it clamps to ``cap`` and ``ovf`` latches a lane
    that passed it.  Returns the roots (T, B, Q) in real ids, NULL where no
    hit.  The ids equal the chunk-level allocation of
    :func:`arena_build_ref` followed by the store translation.
    """
    T, B = class_ids.shape
    W, M, cap, voff = lay.W, lay.M, lay.cap, lay.voffset
    dev = class_ids.device
    i32, i64 = torch.int32, torch.int64
    hits = torch.as_tensor(hits, device=dev).to(i32)
    start, valid = start.to(i64), valid_counts.to(i64)
    gpos = gpos.to(i32)
    finals_sq = finals_sq.to(i32)
    kind_m = torch.from_numpy(lay.kind_static()).to(dev)
    pos_ev = torch.from_numpy(lay.pos_is_event()).to(dev)
    w_m = torch.from_numpy(lay.w_static()).to(dev).long()
    d_m = torch.from_numpy(lay.d_static()).to(dev).long()
    vb = torch.full((B,), voff, dtype=i32, device=dev)
    b_idx = torch.arange(B, device=dev)
    cells = tuple(c.to(i32) for c in cells0)
    sstart = sstart0.to(i32).clone()
    ptr0 = arena["ptr"].to(i64)
    ptr = ptr0.clone()
    roots = torch.full((T, B, lay.Q), ARENA_NULL, dtype=i32, device=dev)
    for t in range(T):
        live = t < valid
        j = start + t
        seed_w = j % W
        sstart[b_idx, seed_w] = torch.where(live, gpos[t],
                                            sstart[b_idx, seed_w])
        cells, (ok, rec_l, rec_r), root = arena_block_step(
            cells, class_ids[t], hits[t], j, live, vb, lay=lay, ptab=ptab,
            finals_sq=finals_sq,
            expire_t=None if expire is None else expire[t],
            consume_t=None if consume is None else consume[t])
        ok = ok > 0
        ok_i = ok.to(i64)
        real = ptr[:, None] + torch.cumsum(ok_i, dim=1) - ok_i   # (B, M)

        def tr(v):                 # step-local virtual ids → real, clamped
            g = torch.gather(real, 1, (v - voff).clamp(0, M - 1).long())
            return torch.where(v >= voff, g.clamp(max=cap), v).to(i32)

        bw, mw = torch.nonzero(ok & (real <= cap), as_tuple=True)
        rw = real[bw, mw]
        gp = gpos[t][bw]
        kinds = kind_m[mw]
        slot = torch.where(d_m[mw] >= 0, (j[bw] - d_m[mw]) % W, w_m[mw])
        fields = {"kind": kinds,
                  "pos": torch.where(pos_ev[mw], gp, ARENA_NULL),
                  "maxs": torch.where(kinds == BOTTOM, gp,
                                      sstart[bw, slot]),
                  "left": tr(rec_l)[bw, mw], "right": tr(rec_r)[bw, mw]}
        for name, val in fields.items():
            arena[name][bw, rw] = val.to(i32)
        cid, cis_u, cleft, cright = (c.reshape(B, -1) for c in cells)
        cells = tuple(x.reshape(cells[0].shape) for x in
                      (tr(cid), cis_u, tr(cleft), tr(cright)))
        roots[t] = torch.where(hits[t] > 0, tr(root), ARENA_NULL)
        ptr = ptr + ok_i.sum(dim=1)
    arena["ovf"] |= ptr > cap
    arena["ptr"].copy_(ptr.clamp(max=cap).to(arena["ptr"].dtype))
    arena["cell"].copy_(cells[0])
    return roots


def assemble_records(cells_fin, recs, roots, T: int, B: int, *,
                     lay: ArenaBlockLayout, n_seg: int):
    """Reorder segmented (steps, n_seg·B, …) emissions back to (T, B, …):
    each segment's W replay steps are dropped."""
    W = lay.W

    def unseg(y):
        if n_seg == 1:
            return y
        G = y.shape[0] - W
        y = y[W:].reshape((G, n_seg, B) + tuple(y.shape[2:]))
        return y.movedim(1, 0).reshape((T, B) + tuple(y.shape[3:]))

    valid, left, right = (unseg(y) for y in recs)
    cells_T = (tuple(c[-B:] for c in cells_fin) if n_seg > 1
               else tuple(cells_fin))
    return cells_T, valid, left, right, unseg(roots)


def arena_slot_starts(sstart0, gpos, start, valid_counts, *, W: int):
    """(T, B, W) per-step slot-start table in closed form (no scan).

    Slot w at step t was last seeded at step ``t' = t_eff − ((start + t_eff
    − w) mod W)`` with ``t_eff = min(t, valid−1)``; if that is negative the
    slot kept its chunk-start label ``sstart0`` (B, W).  Fed with event
    timestamps instead of positions it gives the per-slot timestamp table
    behind the time-eviction masks.
    """
    T, B = gpos.shape
    dev = gpos.device
    ts = torch.arange(T, device=dev)[:, None, None]            # (T, 1, 1)
    t_eff = torch.minimum(
        ts, valid_counts.long().clamp(min=0)[None, :, None] - 1)
    w = torch.arange(W, device=dev)[None, None, :]
    t_seed = t_eff - (start.long()[None, :, None] + t_eff - w) % W
    g = torch.gather(gpos.movedim(1, 0)[:, None, :].expand(B, T, T), 2,
                     t_seed.clamp(0, T - 1).movedim(1, 0))      # (B, T, W)
    return torch.where(t_seed >= 0, g.movedim(1, 0), sstart0[None])
