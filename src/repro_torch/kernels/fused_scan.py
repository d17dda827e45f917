"""Wrapper and launch counter of the Hopper fused-scan kernel.

The kernel (``csrc/fused_scan.cu``) replaces the TPU kernel
``src/repro/kernels/fused_scan.py:fused_scan_pallas``.  It lives in the
port's one kernel library (:mod:`repro_torch.kernels.build`), built with
``nvcc`` for ``sm_90a`` at first use and bound through ``ctypes``.  Nothing
is built or loaded when this module is imported.

Where a lane's ring lives is chosen by :func:`plan_ring`, a pure function of
the geometry: in shared memory, whole, when it fits one block; else split
over ``n_split`` blocks per lane (grid ``(B, n_split)``), each holding a
contiguous share of the slots in shared memory and adding its partial
per-query counts with ``atomicAdd``; LAST and CONSUME BY ANY, which need a
lane-wide decision per event, keep one block per lane and a ring that does
not fit stays in global memory.  The results are the same bit for bit.

The 32-state build steps a slot's row through index lists
(:func:`packed_lists`): for each output state, the source states of its
column of ``M_all[class]``, and for each query its final states, one byte
each.  They are built once per table and kept on the table tensor
(:func:`table_lists`), so a feed adds no device operation and no sync.  A
table with a list longer than :data:`SPARSE_CAP`, or with a non-zero other
than 1, keeps the dense product, as the other builds do.

Use :func:`repro_torch.kernels.ops.cer_pipeline`, which routes CUDA tensors
here and CPU tensors to the plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .build import LIBRARY

# predicates per call: a query compiles to at most 14 (symbolic.MAX_BITS);
# a fleet bucket pads 13 or 14 live ones to 16, the padding never true
MAX_BITS = 16
MAX_THREADS = 256
# det-state template instantiations: rows in registers up to 32 states, the
# wide build (csrc/scan_row.cuh) up to the reference's MAX_DET_STATES
STATE_BUCKETS = (8, 16, 32, 512)
MAX_STATES = STATE_BUCKETS[-1]
MAX_SPLIT = 65535   # blocks per lane (the grid's y extent)
#: the longest column or final-state list the sparse step takes: a source
#: is one byte of the 32-bit word the kernel keeps in a register per state
#: (a narrow build's states fit a byte), so four fill it.  Only the 32-state
#: build takes the step: on an H100 it ran 1.7-1.9x faster than the dense
#: product there (two sources a state), while at 16 states it ran 0.67-1.35x
#: and at 8 states 0.92x, where the dense product's row is short.
SPARSE_CAP = 4
SPARSE_BUCKET = STATE_BUCKETS[-2]
NONE = 0xFF   # a packed list's empty byte

_P = ctypes.c_void_p
_I = ctypes.c_int


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class FusedScanKernel:
    """The kernel's binding and its launch counters.

    ``launches`` counts kernel launches (one per :meth:`__call__`), and
    ``sparse_launches`` those that took the sparse step; ``last_plan`` is
    the ``(use_smem, n_split)`` of the latest launch.
    """

    def __init__(self):
        self.launches = 0
        self.sparse_launches = 0
        self.last_plan = None
        self._lib = None
        self._smem_limit = {}

    # ------------------------------------------------------------------
    def library(self) -> ctypes.CDLL:
        """The shared library, with this kernel's entry points bound."""
        if self._lib is not None:
            return self._lib
        lib = LIBRARY.get()
        lib.fused_scan_launch.restype = _I
        lib.fused_scan_launch.argtypes = (
            [_P, _P, _P, _P, _I] + [_P] * 16 + [_I] * 7 + [ctypes.c_float]
            + [_I] * 7 + [_P])
        lib.fused_scan_max_dynamic_smem.restype = _I
        lib.fused_scan_max_dynamic_smem.argtypes = [_I, ctypes.POINTER(_I)]
        self._lib = lib
        return lib

    def smem_limit(self, max_s: int) -> int:
        """Dynamic shared memory a block of the ``max_s`` bucket may use."""
        if max_s not in self._smem_limit:
            out = _I(0)
            err = self.library().fused_scan_max_dynamic_smem(
                max_s, ctypes.byref(out))
            if err != 0:
                raise RuntimeError(f"fused_scan_max_dynamic_smem failed: "
                                   f"CUDA error {err}")
            self._smem_limit[max_s] = out.value
        return self._smem_limit[max_s]

    # ------------------------------------------------------------------
    def __call__(self, attrs: torch.Tensor,
                 specs: Sequence[Tuple[int, int, float]],
                 class_of: torch.Tensor, m_all: torch.Tensor,
                 finals_q: torch.Tensor, init_mask: torch.Tensor,
                 c: torch.Tensor, start: torch.Tensor, valid: torch.Tensor,
                 *, epsilon: int, time_size: Optional[float] = None,
                 event_ts: Optional[torch.Tensor] = None,
                 ts_ring: Optional[torch.Tensor] = None,
                 ovf: Optional[torch.Tensor] = None,
                 latest_q: Optional[torch.Tensor] = None,
                 consume_sq: Optional[torch.Tensor] = None,
                 return_trace: bool = False, split: Optional[int] = None):
        """Launch on one chunk.  Updates ``c`` (and ``ts_ring``/``ovf`` for
        time windows) in place; returns ``matches (T, B, NQ)`` f32 and, with
        ``return_trace``, the ``(T, B)`` int32 class trace.  ``split``
        forces the number of blocks per lane (:func:`plan_ring`).

        attrs (T, B, A) f32 | class_of (2^k,) int32 | m_all (C, S, S) f32 |
        finals_q (NQ, S) f32 | init_mask (S,) f32 | c (B, W, S) f32 |
        start, valid (B,) int32 | event_ts (T, B) f32 | ts_ring (B, W) f32 |
        ovf (B,) bool | latest_q (NQ,) f32 | consume_sq (NQ, S) f32.
        Raises ``ValueError`` on what the kernel does not take.
        """
        T, B, A = attrs.shape
        NC, S, _ = m_all.shape
        NQ = finals_q.shape[0]
        W = c.shape[1]
        k = len(specs)
        timed = time_size is not None
        check_launchable(T=T, B=B, S=S, NQ=NQ, k=k, W=W, epsilon=epsilon,
                         timed=timed)
        if class_of.shape != (1 << k,):
            raise ValueError(f"class_of must be (2^k,) = ({1 << k},), got "
                             f"{tuple(class_of.shape)}")
        if any(not 0 <= col < A for col, _, _ in specs):
            raise ValueError(f"a predicate reads a column outside A={A}")
        operands = {
            "attrs": (attrs, torch.float32, (T, B, A)),
            "class_of": (class_of, torch.int32, (1 << k,)),
            "m_all": (m_all, torch.float32, (NC, S, S)),
            "finals_q": (finals_q, torch.float32, (NQ, S)),
            "init_mask": (init_mask, torch.float32, (S,)),
            "c": (c, torch.float32, (B, W, S)),
            "start": (start, torch.int32, (B,)),
            "valid": (valid, torch.int32, (B,)),
        }
        if timed:
            operands.update(event_ts=(event_ts, torch.float32, (T, B)),
                            ts_ring=(ts_ring, torch.float32, (B, W)),
                            ovf=(ovf, torch.bool, (B,)))
        if latest_q is not None:
            operands["latest_q"] = (latest_q, torch.float32, (NQ,))
        if consume_sq is not None:
            operands["consume_sq"] = (consume_sq, torch.float32, (NQ, S))
        dev = attrs.device
        for name, (t, dtype, shape) in operands.items():
            if t is None:
                raise ValueError(f"fused_scan needs the {name} operand")
            if t.device != dev or t.device.type != "cuda":
                raise ValueError(f"fused_scan operand {name} is on {t.device}"
                                 f"; every operand must be on {dev} (CUDA)")
            if t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(f"fused_scan operand {name} must be {dtype} "
                                 f"{shape}, got {t.dtype} {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"fused_scan operand {name} must be "
                                 "contiguous")

        max_s = state_bucket(S)
        lists = table_lists(m_all, finals_q)
        (trans, deg), (flist, fdeg) = lists or ((None, 0), (None, 0))
        with torch.cuda.device(dev):
            lib = self.library()
            use_smem, n_split = plan_ring(
                W, S, timed, self.smem_limit(max_s),
                latest=latest_q is not None, consume=consume_sq is not None,
                split=split)
            seg = -(-W // n_split)
            threads = min(MAX_THREADS, max(32, -(-seg // 32) * 32))
            # split segments add their partial counts into zeros
            matches = (torch.zeros if n_split > 1 else torch.empty)(
                (T, B, NQ), dtype=torch.float32, device=dev)
            trace = (torch.empty((T, B), dtype=torch.int32, device=dev)
                     if return_trace else None)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fused_scan_launch(
                attrs.data_ptr(),
                (_I * max(k, 1))(*[int(s[0]) for s in specs]),
                (_I * max(k, 1))(*[int(s[1]) for s in specs]),
                (ctypes.c_float * max(k, 1))(*[float(s[2]) for s in specs]),
                k, class_of.data_ptr(), m_all.data_ptr(),
                finals_q.data_ptr(), _ptr(trans), _ptr(flist),
                init_mask.data_ptr(), _ptr(latest_q),
                _ptr(consume_sq), c.data_ptr(), _ptr(ts_ring), _ptr(ovf),
                _ptr(event_ts), start.data_ptr(), valid.data_ptr(),
                matches.data_ptr(), _ptr(trace), T, B, A, S, NQ, W,
                int(epsilon), ctypes.c_float(time_size if timed else 0.0),
                int(timed), max_s, threads, int(use_smem), n_split, deg,
                fdeg, stream)
        if err != 0:
            raise RuntimeError(f"fused_scan launch failed: CUDA error {err}")
        self.launches += 1
        self.sparse_launches += lists is not None
        self.last_plan = (use_smem, n_split)
        return (matches, trace) if return_trace else matches


def column_lists(table: torch.Tensor, cap: int = SPARSE_CAP
                 ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The non-zeros of each column of ``table`` (..., R, N), as index
    lists along R: ``(src, w)``, both (..., D, N), where column n holds
    ``table[..., src[k, n], n] == w[k, n]`` for its k-th non-zero in
    ascending row order, and ``w`` is 0 past its count.  D is the most
    non-zeros of any column (at least 1).  None when D exceeds ``cap``:
    such a table keeps the dense product.  ``src`` is int32."""
    nz = table != 0
    deg = int(nz.sum(-2).max()) if table.numel() else 0
    if deg > cap:
        return None
    # non-zeros first, each column's in ascending row order
    src = torch.sort(nz.to(torch.int8), dim=-2, descending=True,
                     stable=True).indices.narrow(-2, 0, max(deg, 1))
    return src.to(torch.int32), torch.gather(table, -2, src)


def packed_lists(table: torch.Tensor, cap: int = SPARSE_CAP
                 ) -> Optional[Tuple[torch.Tensor, int]]:
    """``table`` (..., R, N) as the sparse step reads it: ``(words, D)``,
    where ``words`` (..., N) int32 holds column n's sources as bytes, the
    k-th non-zero's row in byte k, and 0xFF in every byte past its count.
    None past ``cap``, or if a non-zero is not 1 (the step adds the sources
    up unweighted): such a table keeps the dense product.  Syncs with the
    device once."""
    cols = column_lists(table, cap)
    if cols is None or not bool(((table == 0) | (table == 1)).all()):
        return None
    src, w = cols
    D = src.shape[-2]
    byte = torch.where(w != 0, src.long(), NONE)
    word = torch.full(byte.shape[:-2] + byte.shape[-1:],
                      sum(NONE << (8 * k) for k in range(D, SPARSE_CAP)),
                      dtype=torch.int64, device=table.device)
    for k in range(D):
        word += byte[..., k, :] << (8 * k)
    # the 32-bit pattern, as int32
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(
        torch.int32).contiguous(), D


def table_cap(S: int) -> int:
    """The longest list a table of ``S`` states takes to the sparse step:
    :data:`SPARSE_CAP` in the 32-state build, 0 (the dense product) in the
    others."""
    return SPARSE_CAP if STATE_BUCKETS[-3] < S <= SPARSE_BUCKET else 0


_CACHE = "_fused_scan_lists"


def _cached(t: torch.Tensor, build):
    """``build(t)``, kept on ``t``'s base tensor under its view geometry and
    version counter: built again only after an in-place write.  Inference
    tensors carry no version counter; their tables are taken as fixed."""
    owner = t if t._base is None else t._base
    key = (t.storage_offset(), tuple(t.shape), t.stride())
    version = -1 if t.is_inference() else t._version
    cache = owner.__dict__.setdefault(_CACHE, {})
    hit = cache.get(key)
    if hit is None or hit[0] != version:
        hit = cache[key] = (version, build(t))
    return hit[1]


def table_lists(m_all: torch.Tensor, finals_q: torch.Tensor
                ) -> Optional[Tuple[Tuple[torch.Tensor, int],
                                    Tuple[torch.Tensor, int]]]:
    """``(transition lists, final lists)`` of ``M_all`` (C, S, S) and the
    finals (NQ, S) (:func:`packed_lists`, each query's final states as a
    word), each built once per table, or None if either takes the dense
    product (:func:`table_cap`)."""
    if table_cap(m_all.shape[-1]) == 0:
        return None
    trans = _cached(m_all, packed_lists)
    flist = _cached(finals_q, lambda f: packed_lists(f.t()))
    return None if trans is None or flist is None else (trans, flist)


def check_launchable(*, T: int, B: int, S: int, NQ: int, k: int, W: int,
                     epsilon: int, timed: bool) -> None:
    """Raise ``ValueError`` for shapes the kernel does not take."""
    if k > MAX_BITS:
        raise ValueError(f"fused_scan takes at most {MAX_BITS} predicates, "
                         f"got {k}")
    if NQ < 1:
        raise ValueError(f"fused_scan takes 1 or more queries, got {NQ}")
    if not 1 <= S <= MAX_STATES:
        raise ValueError(f"fused_scan takes 1..{MAX_STATES} det states (the "
                         f"reference's MAX_DET_STATES), got {S}")
    if B < 1 or T < 0:
        raise ValueError(f"fused_scan needs B ≥ 1 and T ≥ 0, got B={B} "
                         f"T={T}")
    if not timed and W < epsilon + 1:
        raise ValueError(f"ring {W} < epsilon+1 ({epsilon + 1})")
    if W * S >= 2 ** 31:
        raise ValueError(f"fused_scan ring W·S must stay below 2^31, got "
                         f"{W}·{S}")


def state_bucket(S: int) -> int:
    """The template instantiation of both scan kernels that takes ``S``
    states."""
    return next(m for m in STATE_BUCKETS if S <= m)


def ring_share_bytes(slots: int, S: int, timed: bool) -> int:
    """Shared memory of ``slots`` ring slots: rows of ``S | 1`` floats (an
    odd stride spreads neighbouring slots over the banks), plus one
    timestamp per slot for a time window."""
    return slots * ((S | 1) + int(timed)) * 4


def segments(W: int, n_split: int) -> list:
    """The ``[w0, w1)`` slot ranges of the ``n_split`` blocks of a lane, as
    the kernel cuts them: ``ceil(W / n_split)`` slots each, the last
    shorter."""
    L = -(-W // n_split)
    return [(y * L, min(W, (y + 1) * L)) for y in range(n_split)]


def plan_ring(W: int, S: int, timed: bool, smem_limit: int, *,
              latest: bool, consume: bool,
              split: Optional[int] = None) -> Tuple[bool, int]:
    """Where a lane's ring lives during a launch: ``(use_smem, n_split)``.

    A ring whose ``W`` slots fit ``smem_limit`` bytes stays whole in one
    block's shared memory (``(True, 1)``).  Otherwise LAST or CONSUME
    (``latest``/``consume``), which decide per event over the whole lane,
    keep one block in global memory (``(False, 1)``), and every other call
    takes the smallest ``n_split`` whose share fits.  ``split`` forces the
    number of blocks (the card tests and ``chip_smoke.py`` use it at small
    shapes); it is trimmed so no block is left without slots, and its
    share lies in global memory if it does not fit.  Raises ``ValueError``
    for a split with LAST or CONSUME, or outside ``1..W``.
    """
    if split is not None:
        check_split(split, W, latest=latest, consume=consume)
        L = -(-W // split)
        return ring_share_bytes(L, S, timed) <= smem_limit, -(-W // L)
    if ring_share_bytes(W, S, timed) <= smem_limit:
        return True, 1
    if latest or consume:
        return False, 1
    return True, -(-W // (smem_limit // ring_share_bytes(1, S, timed)))


def check_split(split: int, W: int, *, latest: bool, consume: bool) -> None:
    """Raise ``ValueError`` for a forced split the kernel cannot run."""
    if latest or consume:
        raise ValueError("split= runs the sum-only mode: LAST and CONSUME "
                         "BY ANY keep one block per lane")
    if not 1 <= split <= min(W, MAX_SPLIT):
        raise ValueError(f"split must lie in 1..{min(W, MAX_SPLIT)} (ring "
                         f"W={W}), got {split}")


#: the process's kernel: one library load serves every engine
KERNEL = FusedScanKernel()
