"""Routers of the device kernels: the Hopper kernel or its plain version.

:func:`arena_block_update` routes the block tECS builder the same way as
:func:`cer_pipeline`, the one entry point of the device CER pipeline:

* ``impl="fused"`` on CUDA tensors launches the hand-written kernel
  (:mod:`repro_torch.kernels.fused_scan`) or raises ``ValueError`` for
  shapes it does not take; there is no silent fallback.  On CPU tensors it
  runs the plain version.
* ``impl="ref"`` runs the plain version (:mod:`repro_torch.kernels.ref`) on
  whatever device the tensors lie on.
* ``impl="unfused"`` (the three-kernel baseline) is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import ref
from .arena_update import KERNEL as ARENA_KERNEL
from .fused_scan import KERNEL
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
                 inplace: bool = False) -> Tuple:
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
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
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
    if impl == "unfused":
        raise NotImplementedError(
            "impl='unfused' needs the bitvector and cea_scan kernels, which "
            "are not ported yet (ROADMAP.md Queue 2, items 3-5)")

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
                 return_trace=return_trace, **time_kw)
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
    cells_fin, recs, roots = ARENA_KERNEL(
        cells0_seg, xs[:5], lay=lay, ptab=ptab,
        finals_sq=torch.as_tensor(finals_sq).cpu().numpy(), expire=exp_s,
        consume=con_s)
    return ref.assemble_records(cells_fin,
                                tuple(r.movedim(0, 1) for r in recs),
                                roots.movedim(0, 1), T, B, lay=lay,
                                n_seg=n_seg)


def _clone_state(state):
    if isinstance(state, dict):
        return {k: v.clone() for k, v in state.items()}
    return state.clone()


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
