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
"""
from __future__ import annotations

from typing import Tuple

import torch

# op codes shared with the kernel's predicate stage
OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE = range(6)


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
        M = M_all[class_ids[t].long()]                         # (B, S, S)
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
        M = M_all[class_ids[t].long()]
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
