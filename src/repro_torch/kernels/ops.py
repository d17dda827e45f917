"""Routers of the device kernels: the Hopper kernel or its plain version.

Every router launches its hand-written kernel on CUDA tensors, or raises
``ValueError`` for what the kernel does not take; there is no silent
fallback.  On CPU tensors it runs the plain version
(:mod:`repro_torch.kernels.ref`).  :func:`cer_pipeline` is the one entry
point of the device CER pipeline:

* ``impl="fused"`` — one launch of the fused-scan kernel
  (:mod:`repro_torch.kernels.fused_scan`).
* ``impl="unfused"`` — the three-dispatch baseline: the bit-vector kernel
  (:func:`bitvector`), the ``class_of[bits]`` gather as a torch indexing op,
  and the packed scan kernel (:func:`cea_scan_multi`).  The scan kernels
  take count windows, one scalar ``start_pos`` and ANY semantics; other
  calls (:func:`unfused_refusal`) go where the reference package sends
  them: the fused kernel on CUDA, the plain version on the CPU.
* ``impl="ref"`` — the plain version on whatever device the tensors lie on.

:func:`arena_store_update` routes the block tECS builder that writes the
node store (the engines' route) the same way, :func:`arena_block_update`
the builder that emits the TPU kernel's dense records (segmented chunks),
and :func:`lane_route` the partitioned engine's lane router.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import cea_scan as scan_kernels
from . import ref
from .arena_update import DENSE as ARENA_DENSE
from .arena_update import KERNEL as ARENA_KERNEL
from .bitvector import KERNEL as BITVECTOR_KERNEL
from .bitvector import check_specs
from .fused_scan import KERNEL, check_split
from .lane_route import KERNEL as LANE_ROUTE_KERNEL
from .window import DeviceWindow

IMPLS = ("fused", "unfused", "ref")


def class_indicator(class_of: np.ndarray, num_classes: int) -> torch.Tensor:
    """``(2^k,)`` class lookup → ``(≥2^k, C)`` one-hot indicator, rows
    padded to a multiple of 8 — the reference package's table layout, kept
    in :class:`~repro_torch.vector.engine.VectorQueryTables` so tables move
    between the packages unchanged.  The kernel reads ``class_of``."""
    class_of = np.asarray(class_of)
    V = class_of.shape[0]
    ind = np.zeros((((max(V, 1) + 7) // 8) * 8, num_classes), np.float32)
    ind[np.arange(V), class_of] = 1.0
    return torch.from_numpy(ind)


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on CUDA or the CPU, got {t.device}")
    return t.device.type == "cuda"


def _scalar_start(start_pos, what: str) -> int:
    """The scan kernels take one start position for every lane."""
    if isinstance(start_pos, torch.Tensor):
        if start_pos.ndim != 0:
            raise ValueError(f"{what} takes one scalar start_pos for every "
                             f"lane, got shape {tuple(start_pos.shape)}")
        return int(start_pos.item())
    if np.ndim(start_pos) != 0:
        raise ValueError(f"{what} takes one scalar start_pos for every lane")
    return int(start_pos)


def bitvector(attrs: torch.Tensor,
              specs: Sequence[Tuple[int, int, float]]) -> torch.Tensor:
    """(N, A) f32 × predicate specs ``(column, op, threshold)`` → (N,) int32
    packed predicate bits (bit i ⇔ predicate i holds).

    CUDA tensors launch the bit-vector kernel
    (:mod:`repro_torch.kernels.bitvector`); CPU tensors run the plain
    version.  Both refuse more than 31 predicates (``ValueError``)."""
    check_specs(specs, attrs)
    if not _on_cuda(attrs, "bitvector"):
        return ref.bitvector(attrs, specs)
    return BITVECTOR_KERNEL(attrs.contiguous(), specs)


def cea_scan(class_ids: torch.Tensor, m_all: torch.Tensor,
             finals: torch.Tensor, c0: torch.Tensor, *, epsilon: int,
             start_pos: Union[int, torch.Tensor] = 0, init_state: int = 1,
             inplace: bool = False, split: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-query windowed scan over precomputed classes.

    class_ids (T, B) int32 | m_all (C, S, S) f32 | finals (S,) | c0 (B, W, S)
    with W ≥ ε+1 → (matches (T, B) f32, c_final (B, W, S) f32).  A fresh
    run starts at ``init_state`` every step; ``start_pos`` is one scalar
    for every lane.  Any ring W ≥ ε+1 gives the same matches.  CUDA tensors
    launch the scan kernel (:data:`repro_torch.kernels.cea_scan.SINGLE`);
    CPU tensors run the plain version.  ``inplace=True`` updates ``c0``.
    ``split`` forces the kernel's blocks per lane
    (:func:`repro_torch.kernels.fused_scan.plan_ring`); it changes no
    result, and every route raises ``ValueError`` outside ``1..W``.
    """
    start = _scalar_start(start_pos, "cea_scan")
    _check_scan_split(split, c0)
    if not _on_cuda(class_ids, "cea_scan"):
        matches, c_fin = ref.cea_scan(class_ids, m_all, finals, c0,
                                      epsilon=epsilon, start_pos=start,
                                      init_state=init_state)
        return matches, _store(c0, c_fin, inplace)
    c = c0 if inplace else c0.clone()
    matches = scan_kernels.SINGLE(class_ids, m_all, finals, c,
                                  epsilon=epsilon, start=start,
                                  init_state=init_state, split=split)
    return matches, c


def cea_scan_multi(class_ids: torch.Tensor, m_all: torch.Tensor,
                   finals_q: torch.Tensor, c0: torch.Tensor, *,
                   init_mask: torch.Tensor, epsilon: int,
                   start_pos: Union[int, torch.Tensor] = 0,
                   inplace: bool = False, split: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed multi-query windowed scan over precomputed classes.

    class_ids (T, B) int32 | m_all (C, S, S) f32 | finals_q (Q, S) |
    init_mask (S,) multi-hot seed | c0 (B, W, S) with W ≥ ε+1 → (matches
    (T, B, Q) f32, c_final (B, W, S) f32).  Count windows, ANY semantics,
    one scalar ``start_pos`` for every lane.  CUDA tensors launch the scan
    kernel (:data:`repro_torch.kernels.cea_scan.MULTI`); CPU tensors run
    the plain version.  ``inplace=True`` updates ``c0``.  ``split`` as in
    :func:`cea_scan`.
    """
    start = _scalar_start(start_pos, "cea_scan_multi")
    _check_scan_split(split, c0)
    if not _on_cuda(class_ids, "cea_scan_multi"):
        matches, c_fin = ref.cea_scan_multi(class_ids, m_all, finals_q, c0,
                                            init_mask=init_mask,
                                            epsilon=epsilon, start_pos=start)
        return matches, _store(c0, c_fin, inplace)
    c = c0 if inplace else c0.clone()
    matches = scan_kernels.MULTI(class_ids, m_all, finals_q, c,
                                 epsilon=epsilon, start=start,
                                 init_mask=init_mask, split=split)
    return matches, c


def _check_scan_split(split: Optional[int], c0: torch.Tensor) -> None:
    """A forced split must lie in ``1..W`` on every route."""
    if split is not None:
        check_split(split, c0.shape[1] if c0.ndim == 3 else 0,
                    latest=False, consume=False)


def _store(c0: torch.Tensor, c_fin: torch.Tensor,
           inplace: bool) -> torch.Tensor:
    """``inplace``: copy the plain version's final ring into ``c0``."""
    if not inplace:
        return c_fin
    c0.copy_(c_fin)
    return c0


def unfused_refusal(window: DeviceWindow, start_pos, valid_counts,
                    latest_q, consume_sq) -> Optional[str]:
    """Why the three-kernel path cannot take a call, or None.

    The scan kernels (as the TPU kernels they replace) take count windows,
    one scalar start for every lane and ANY semantics only;
    :func:`cer_pipeline` sends the other calls to the fused route."""
    if window.is_time:
        return "a time window"
    if isinstance(start_pos, (torch.Tensor, np.ndarray)) and \
            np.ndim(start_pos) >= 1:
        return "per-lane start_pos offsets"
    if valid_counts is not None:
        return "per-lane valid_counts"
    if latest_q is not None:
        return "LAST (latest_q)"
    if consume_sq is not None:
        return "CONSUME BY ANY (consume_sq)"
    return None


def cer_pipeline(attrs: torch.Tensor,
                 specs: Sequence[Tuple[int, int, float]],
                 class_of: torch.Tensor, class_ind: torch.Tensor,
                 m_all: torch.Tensor, finals_q: torch.Tensor,
                 c0, *, init_mask: torch.Tensor,
                 epsilon: Optional[int] = None,
                 window: Optional[DeviceWindow] = None,
                 event_ts: Optional[torch.Tensor] = None,
                 start_pos: Union[int, torch.Tensor] = 0,
                 valid_counts: Optional[torch.Tensor] = None,
                 impl: str = "fused",
                 return_trace: bool = False,
                 latest_q: Optional[torch.Tensor] = None,
                 consume_sq: Optional[torch.Tensor] = None,
                 inplace: bool = False,
                 split: Optional[int] = None) -> Tuple:
    """Device CER pipeline: raw attributes → per-position match counts.

    attrs (T, B, A) f32 | class_of (2^k,) int32 | class_ind (≥2^k, C) f32
    (the one-hot form of ``class_of``, accepted for the reference
    package's signature; the lookup reads ``class_of``) | m_all (C, S, S) |
    finals_q (Q, S) | init_mask (S,) | c0 (B, W, S)
    → (matches (T, B, Q) f32, c_final (B, W, S) f32).

    ``return_trace=True`` appends the per-event class trace ``(T, B)``
    int32.  ``start_pos`` is a scalar or a ``(B,)`` vector of per-lane
    positions; ``valid_counts`` ``(B,)`` marks each lane's dense prefix of
    real events (later steps are no-ops for that lane).  ``latest_q``
    ``(Q,)`` flags LAST queries; ``consume_sq`` ``(Q, S)`` maps CONSUME BY
    ANY queries to the states they clear after emitting.

    Windows: pass ``epsilon=`` (count window) or a :class:`DeviceWindow` as
    ``window=``.  Time windows take ``event_ts`` ``(T, B)`` f32 and the
    ``{"C", "ts", "ovf"}`` state dict, and return the same form.

    ``inplace=True`` updates ``c0``'s tensors and returns them (the
    streaming engine's preallocated buffers); otherwise ``c0`` is left
    untouched.

    ``impl`` routes fused / unfused / ref (module docstring).  ``split``
    forces the blocks per lane of the scan kernel that runs, fused or
    packed (:func:`repro_torch.kernels.fused_scan.plan_ring`); it changes
    no result, so the plain route only checks it: every route raises
    ``ValueError`` for a split with LAST or CONSUME or outside ``1..W``.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if split is not None:
        W = (c0["C"] if isinstance(c0, dict) else c0).shape[1]
        check_split(split, W, latest=latest_q is not None,
                    consume=consume_sq is not None)
    if window is None:
        if epsilon is None:
            raise ValueError("cer_pipeline needs epsilon= or window=")
        window = DeviceWindow.events(epsilon)
    timed = window.is_time
    epsilon = window.epsilon
    if timed and event_ts is None:
        raise ValueError("time windows need the event_ts (T, B) operand")
    T, B, A = attrs.shape
    if timed:
        event_ts = torch.as_tensor(event_ts, dtype=torch.float32,
                                   device=attrs.device)
        if tuple(event_ts.shape) != (T, B):
            raise ValueError(f"event_ts must be (T, B) = ({T}, {B}) like "
                             f"attrs, got {tuple(event_ts.shape)}")
    # the reference package sends what the scan kernels do not take to its
    # fused computation: here the fused kernel, or the plain version below
    if impl == "unfused" and unfused_refusal(
            window, start_pos, valid_counts, latest_q, consume_sq) is None:
        return _pipeline_unfused(attrs, specs, class_of, m_all, finals_q,
                                 c0, init_mask, epsilon, start_pos,
                                 return_trace, inplace, split)

    if impl == "ref" or attrs.device.type == "cpu":
        return _pipeline_plain(attrs, specs, class_of, m_all, finals_q, c0,
                               init_mask, window, event_ts, start_pos,
                               valid_counts, return_trace, latest_q,
                               consume_sq, inplace)
    if attrs.device.type != "cuda":
        raise ValueError(f"cer_pipeline runs on CUDA or the CPU, got "
                         f"{attrs.device}")

    state = c0 if inplace else _clone_state(c0)
    c_ring = state["C"] if timed else state
    start = ref.lane_vector(start_pos, B, attrs.device).to(
        torch.int32).contiguous()
    valid = ref.lane_vector(T if valid_counts is None else valid_counts, B,
                            attrs.device, "valid_counts").to(
        torch.int32).contiguous()
    time_kw = {}
    if timed:
        time_kw = dict(time_size=float(window.size),
                       event_ts=event_ts.contiguous(),
                       ts_ring=state["ts"], ovf=state["ovf"])
    res = KERNEL(attrs.contiguous(), specs, class_of, m_all, finals_q,
                 init_mask, c_ring, start, valid, epsilon=epsilon,
                 latest_q=latest_q, consume_sq=consume_sq,
                 return_trace=return_trace, split=split, **time_kw)
    if return_trace:
        matches, trace = res
        return matches, state, trace
    return res, state


def arena_block_update(cells0, class_ids: torch.Tensor, hits, start,
                       valid_counts, *, lay: ref.ArenaBlockLayout,
                       ptab: torch.Tensor, finals_sq, n_seg: int = 1,
                       expire: Optional[torch.Tensor] = None,
                       consume: Optional[torch.Tensor] = None,
                       impl: str = "fused"):
    """Block tECS builder over one chunk: the Hopper kernel or its plain
    version.

    cells0: four (B, W, S) int32 tensors (node id / is-union / left /
    right: the chunk-start cell table).  class_ids: (T, B) int32; hits:
    (T, B, Q) bool or int32; start/valid_counts: scalars or (B,).  ptab:
    (C, S, K, 3) int32 packed predecessor tables on the tensors' device.
    n_seg: parallel chunk segments (:func:`ref.pick_segments`).  expire:
    optional (T, B, W) time-eviction masks; consume: optional (T, B, S)
    CONSUME BY ANY clear masks.  Returns ``(cells_T, valid, left, right,
    roots)``: records (T, B, M) and roots (T, B, Q) on virtual node ids.

    CUDA tensors with ``impl="fused"`` go to the kernel
    (:mod:`repro_torch.kernels.arena_update`), which raises ``ValueError``
    for shapes it does not take; CPU tensors or ``impl="ref"`` go to
    :func:`ref.arena_build_ref`.  There is no silent fallback.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    T, B = class_ids.shape
    dev = class_ids.device
    start = ref.lane_vector(start, B, dev).to(torch.int32)
    valid_counts = ref.lane_vector(valid_counts, B, dev,
                                   "valid_counts").to(torch.int32)
    if impl == "ref" or dev.type == "cpu":
        return ref.arena_build_ref(cells0, class_ids, hits, start,
                                   valid_counts, lay=lay, ptab=ptab,
                                   finals_sq=finals_sq, n_seg=n_seg,
                                   expire=expire, consume=consume)
    if dev.type != "cuda":
        raise ValueError(f"arena_block_update runs on CUDA or the CPU, got "
                         f"{dev}")
    xs, cells0_seg = ref.segment_operands(
        tuple(c.to(torch.int32).contiguous() for c in cells0), class_ids,
        hits, start, valid_counts, lay=lay, n_seg=n_seg, expire=expire,
        consume=consume)
    extra = list(xs[5:])
    exp_s = extra.pop(0) if expire is not None else None
    con_s = extra.pop(0) if consume is not None else None
    cells_fin, recs, roots = ARENA_DENSE(
        cells0_seg, xs[:5], lay=lay, ptab=ptab,
        finals_sq=torch.as_tensor(finals_sq).cpu().numpy(), expire=exp_s,
        consume=con_s)
    return ref.assemble_records(cells_fin,
                                tuple(r.movedim(0, 1) for r in recs),
                                roots.movedim(0, 1), T, B, lay=lay,
                                n_seg=n_seg)


def arena_store_update(arena: dict, cells0, sstart0, class_ids: torch.Tensor,
                       hits, gpos: torch.Tensor, start, valid_counts, *,
                       lay: ref.ArenaBlockLayout, ptab: torch.Tensor,
                       finals_sq, expire: Optional[torch.Tensor] = None,
                       consume: Optional[torch.Tensor] = None,
                       impl: str = "fused") -> torch.Tensor:
    """Block tECS builder over one chunk that allocates node ids itself and
    writes the node store: the Hopper store kernel or its plain version.

    arena: the node store dict, updated in place (``kind``, ``pos``,
    ``maxs``, ``left``, ``right``, ``cell``, ``ptr``, ``ovf``).  cells0 and
    sstart0: the chunk-start cell table and slot starts
    (``vector.tecs_arena.chunk_cells``; ``cells0[0]`` is the arena's own
    ``cell`` tensor).  class_ids/gpos: (T, B) int32; hits: (T, B, Q);
    start/valid_counts: scalars or (B,); expire (T, B, W) and consume
    (T, B, S) optional masks.  Returns the roots (T, B, Q) in real ids,
    NULL where no hit.  Ids, stores and roots equal
    :func:`arena_block_update` followed by the chunk-level translation.

    CUDA tensors with ``impl="fused"`` launch the store kernel
    (:data:`repro_torch.kernels.arena_update.KERNEL`), which raises
    ``ValueError`` for shapes it does not take; CPU tensors or
    ``impl="ref"`` run :func:`ref.arena_store_ref`.  No fallback.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    T, B = class_ids.shape
    dev = class_ids.device
    start = ref.lane_vector(start, B, dev).to(torch.int32)
    valid_counts = ref.lane_vector(valid_counts, B, dev,
                                   "valid_counts").to(torch.int32)
    if impl == "ref" or dev.type == "cpu":
        return ref.arena_store_ref(arena, cells0, sstart0, class_ids, hits,
                                   gpos, start, valid_counts, lay=lay,
                                   ptab=ptab, finals_sq=finals_sq,
                                   expire=expire, consume=consume)
    if dev.type != "cuda":
        raise ValueError(f"arena_store_update runs on CUDA or the CPU, got "
                         f"{dev}")
    xs, _ = ref.segment_operands(
        cells0, class_ids, hits, start, valid_counts, lay=lay, n_seg=1,
        expire=expire, consume=consume)
    extra = list(xs[5:])
    exp_s = extra.pop(0) if expire is not None else None
    con_s = extra.pop(0) if consume is not None else None
    roots = ARENA_KERNEL(
        arena, tuple(c.to(torch.int32) for c in cells0),
        sstart0.to(torch.int32).contiguous(), xs[:4],
        gpos.to(torch.int32).contiguous(), lay=lay, ptab=ptab,
        finals_sq=torch.as_tensor(finals_sq).cpu().numpy(), expire=exp_s,
        consume=con_s)
    return torch.where(torch.as_tensor(hits, device=dev).bool(),
                       roots.movedim(0, 1), ref.ARENA_NULL)


def lane_route(keys, lane_keys, lane_last: torch.Tensor, *, chunk_idx: int,
               cap: int, evict: str = "lru", impl: str = "fused"
               ) -> ref.LaneRoute:
    """One chunk's lane assignment of the partitioned engine: the Hopper
    router or its plain version.

    keys (T,) and lane_keys (L,): 32-bit partition hashes (uint32, int32
    bit patterns or int64 values); lane_last (L,) int32; ``cap`` the lane
    capacity of the chunk (``fill`` is capped at it, ranks are not).
    Returns a :class:`repro_torch.kernels.ref.LaneRoute`.  CUDA tensors
    launch the kernel (:data:`repro_torch.kernels.lane_route.KERNEL`),
    which raises ``ValueError`` for what it does not take; CPU tensors or
    ``impl="ref"`` run :func:`ref.lane_route_ref`.  No fallback.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    keys, lane_keys = ref.key_bits(keys), ref.key_bits(lane_keys)
    lane_last = torch.as_tensor(lane_last).to(torch.int32)
    kw = dict(chunk_idx=int(chunk_idx), cap=int(cap), evict=evict)
    if impl == "ref" or not _on_cuda(keys, "lane_route"):
        return ref.lane_route_ref(keys, lane_keys, lane_last, **kw)
    return LANE_ROUTE_KERNEL(keys.contiguous(), lane_keys.contiguous(),
                             lane_last.contiguous(), **kw)


def _clone_state(state):
    if isinstance(state, dict):
        return {k: v.clone() for k, v in state.items()}
    return state.clone()


def _pipeline_unfused(attrs, specs, class_of, m_all, finals_q, c0,
                      init_mask, epsilon, start_pos, return_trace, inplace,
                      split):
    """The three-dispatch path: bits → ``class_of[bits]`` → packed scan."""
    T, B, A = attrs.shape
    bits = bitvector(attrs.reshape(T * B, A), specs)
    class_ids = class_of[bits.long()].reshape(T, B).to(torch.int32)
    matches, c_fin = cea_scan_multi(class_ids, m_all, finals_q, c0,
                                    init_mask=init_mask, epsilon=epsilon,
                                    start_pos=start_pos, inplace=inplace,
                                    split=split)
    if return_trace:
        return matches, c_fin, class_ids
    return matches, c_fin


def _pipeline_plain(attrs, specs, class_of, m_all, finals_q, c0, init_mask,
                    window, event_ts, start_pos, valid_counts, return_trace,
                    latest_q, consume_sq, inplace):
    """The plain PyTorch version end to end: trace, then the scan."""
    dev = attrs.device
    idx = torch.tensor([s[0] for s in specs], dtype=torch.int32, device=dev)
    ops_ = torch.tensor([s[1] for s in specs], dtype=torch.int32, device=dev)
    thr = torch.tensor([s[2] for s in specs], dtype=torch.float32,
                       device=dev)
    class_ids = ref.class_trace_ref(attrs, idx, ops_, thr, class_of)
    c_fin, matches = ref.cea_scan_multi_ref(
        c0, m_all, class_ids, finals_q, init_mask, window.epsilon,
        start_pos=start_pos, valid_counts=valid_counts, window=window,
        event_ts=event_ts, latest_q=latest_q, consume_sq=consume_sq)
    if inplace:
        if isinstance(c0, dict):
            for k in c0:
                c0[k].copy_(c_fin[k])
        else:
            c0.copy_(c_fin)
        c_fin = c0
    if return_trace:
        return matches, c_fin, class_ids
    return matches, c_fin
