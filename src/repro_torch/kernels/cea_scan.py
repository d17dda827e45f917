"""Wrappers and launch counters of the Hopper scan kernels of the unfused
pipeline.

One source (``csrc/cea_scan.cu``) with two launch entries replaces two TPU
kernels of ``src/repro/kernels/cea_scan.py``:

* :data:`MULTI` — ``cea_scan_multi_pallas``, the packed multi-query scan
  (multi-hot seed, per-query finals);
* :data:`SINGLE` — ``cea_scan_pallas``, the single-query scan (one-hot seed
  at ``init_state``, one finals row).

Each has its own launch counter and ``last_plan``.  A lane's ring lives
where :func:`repro_torch.kernels.fused_scan.plan_ring` puts the fused
kernel's: whole in one block's shared memory when it fits, else split over
``n_split`` blocks per lane (grid ``(B, n_split)``), each holding a
contiguous share in shared memory and adding its partial per-query counts
with ``atomicAdd``.  The scans take neither LAST nor CONSUME, so every ring
that does not fit splits.  They live in the port's one kernel library
(:mod:`repro_torch.kernels.build`), built at first use; nothing is built or
loaded when this module is imported.

Use :func:`repro_torch.kernels.ops.cea_scan` and
:func:`~repro_torch.kernels.ops.cea_scan_multi`, which route CUDA tensors
here and CPU tensors to the plain versions in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import LIBRARY
from .fused_scan import MAX_STATES, plan_ring, state_bucket

MAX_THREADS = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SMEM_LIMIT = {}
_LIB = None


def _library() -> ctypes.CDLL:
    """The shared library with both scan entry points bound."""
    global _LIB
    if _LIB is None:
        lib = LIBRARY.get()
        lib.cea_scan_multi_launch.restype = _I
        lib.cea_scan_multi_launch.argtypes = (
            [_P] * 6 + [_LL] + [_I] * 11 + [_P])
        lib.cea_scan_launch.restype = _I
        lib.cea_scan_launch.argtypes = (
            [_P] * 3 + [_I] + [_P] * 2 + [_LL] + [_I] * 10 + [_P])
        lib.cea_scan_max_dynamic_smem.restype = _I
        lib.cea_scan_max_dynamic_smem.argtypes = [_I, ctypes.POINTER(_I)]
        _LIB = lib
    return _LIB


def _smem_limit(max_s: int) -> int:
    """Dynamic shared memory a block of the ``max_s`` bucket may use."""
    if max_s not in _SMEM_LIMIT:
        out = _I(0)
        err = _library().cea_scan_max_dynamic_smem(max_s, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"cea_scan_max_dynamic_smem failed: CUDA "
                               f"error {err}")
        _SMEM_LIMIT[max_s] = out.value
    return _SMEM_LIMIT[max_s]


def check_launchable(*, T: int, B: int, S: int, NQ: int, W: int,
                     epsilon: int, NC: int = 1) -> None:
    """Raise ``ValueError`` for shapes the kernels do not take."""
    if NC < 1:
        raise ValueError("cea_scan needs at least one symbol class")
    if NQ < 1:
        raise ValueError(f"cea_scan takes 1 or more queries, got {NQ}")
    if not 1 <= S <= MAX_STATES:
        raise ValueError(f"cea_scan takes 1..{MAX_STATES} det states (the "
                         f"reference's MAX_DET_STATES), got {S}")
    if B < 1 or T < 0 or epsilon < 0:
        raise ValueError(f"cea_scan needs B ≥ 1, T ≥ 0 and epsilon ≥ 0, got "
                         f"B={B} T={T} epsilon={epsilon}")
    if W < epsilon + 1:
        raise ValueError(f"ring {W} < epsilon+1 ({epsilon + 1})")
    if W * S >= 2 ** 31:
        raise ValueError(f"cea_scan ring W·S must stay below 2^31, got "
                         f"{W}·{S}")


class CeaScanKernel:
    """One launch entry of ``csrc/cea_scan.cu`` and its launch counter.

    ``multi=True`` is the packed scan (init mask, ``(NQ, S)`` finals,
    matches ``(T, B, NQ)``); ``multi=False`` the single-query scan
    (``init_state``, ``(S,)`` finals, matches ``(T, B)``).  ``launches``
    counts kernel launches of this entry; ``last_plan`` is the
    ``(use_smem, n_split)`` of its latest launch.
    """

    def __init__(self, multi: bool):
        self.multi = multi
        self.name = "cea_scan_multi" if multi else "cea_scan"
        self.launches = 0
        self.last_plan = None

    def __call__(self, class_ids: torch.Tensor, m_all: torch.Tensor,
                 finals: torch.Tensor, c: torch.Tensor, *, epsilon: int,
                 start: int, init_mask: Optional[torch.Tensor] = None,
                 init_state: int = 1,
                 split: Optional[int] = None) -> torch.Tensor:
        """Launch on one chunk; updates the ring ``c`` in place and returns
        the matches.

        class_ids (T, B) int32 | m_all (C, S, S) f32 | finals (NQ, S) f32
        (multi) or (S,) f32 | c (B, W, S) f32 | init_mask (S,) f32 (multi
        only) | start: the stream position of the chunk's first event, one
        for every lane.  ``split`` forces the number of blocks per lane
        (:func:`~repro_torch.kernels.fused_scan.plan_ring`).  Raises
        ``ValueError`` on what the kernel does not take.
        """
        T, B = class_ids.shape
        NC, S, _ = m_all.shape
        W = c.shape[1] if c.ndim == 3 else 0
        NQ = finals.shape[0] if self.multi else 1
        check_launchable(T=T, B=B, S=S, NQ=NQ, W=W, epsilon=epsilon,
                         NC=NC)
        operands = {
            "class_ids": (class_ids, torch.int32, (T, B)),
            "m_all": (m_all, torch.float32, (NC, S, S)),
            "finals": (finals, torch.float32,
                       (NQ, S) if self.multi else (S,)),
            "c": (c, torch.float32, (B, W, S)),
        }
        if self.multi:
            operands["init_mask"] = (init_mask, torch.float32, (S,))
        dev = class_ids.device
        for name, (t, dtype, shape) in operands.items():
            if t is None:
                raise ValueError(f"{self.name} needs the {name} operand")
            if t.device != dev or t.device.type != "cuda":
                raise ValueError(f"{self.name} operand {name} is on "
                                 f"{t.device}; every operand must be on "
                                 f"{dev} (CUDA)")
            if t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(f"{self.name} operand {name} must be "
                                 f"{dtype} {shape}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{self.name} operand {name} must be "
                                 "contiguous")

        max_s = state_bucket(S)
        with torch.cuda.device(dev):
            use_smem, n_split = plan_ring(W, S, False, _smem_limit(max_s),
                                          latest=False, consume=False,
                                          split=split)
            seg = -(-W // n_split)
            threads = min(MAX_THREADS, max(32, -(-seg // 32) * 32))
            lib = _library()
            out_shape = (T, B, NQ) if self.multi else (T, B)
            # split segments add their partial counts into zeros
            matches = (torch.zeros if n_split > 1 else torch.empty)(
                out_shape, dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            if self.multi:
                err = lib.cea_scan_multi_launch(
                    class_ids.data_ptr(), m_all.data_ptr(),
                    finals.data_ptr(), init_mask.data_ptr(), c.data_ptr(),
                    matches.data_ptr(), int(start), T, B, S, NQ, NC, W,
                    int(epsilon), max_s, threads, int(use_smem), n_split,
                    stream)
            else:
                err = lib.cea_scan_launch(
                    class_ids.data_ptr(), m_all.data_ptr(),
                    finals.data_ptr(), int(init_state), c.data_ptr(),
                    matches.data_ptr(), int(start), T, B, S, NC, W,
                    int(epsilon), max_s, threads, int(use_smem), n_split,
                    stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        self.last_plan = (use_smem, n_split)
        return matches


#: the packed multi-query entry (``cea_scan_multi_pallas``)
MULTI = CeaScanKernel(multi=True)
#: the single-query entry (``cea_scan_pallas``)
SINGLE = CeaScanKernel(multi=False)
