"""Wrapper and launch counter of the Hopper block tECS builder kernel.

The kernel (``csrc/arena_update.cu``) replaces the TPU kernel
``src/repro/kernels/arena_update.py:arena_update_pallas``.  It lives in the
port's one kernel library (:mod:`repro_torch.kernels.build`), built with
``nvcc`` for ``sm_90a`` at first use and bound through ``ctypes``.  Nothing
is built or loaded when this module is imported.

Use :func:`repro_torch.kernels.ops.arena_block_update`, which routes CUDA
tensors here and CPU tensors to :func:`repro_torch.kernels.ref.
arena_build_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from .build import LIBRARY
from .ref import ARENA_NULL, ArenaBlockLayout

MAX_STATES = 32
MAX_QUERIES = 8     # one warp of the 256-thread block per query's chain
INT32_MAX = 2 ** 31 - 1

_P = ctypes.c_void_p
_I = ctypes.c_int


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def layout_table(lay: ArenaBlockLayout, finals_sq) -> np.ndarray:
    """The kernel's static layout tables as one int32 vector: ranks of the
    states in the extend and union regions (K, S) each, the region offsets
    and sizes (K,) each, per state the same-slot root region (−2: not a
    relevant final state, −1: the first one, else its offset), the seed
    targets (S,) and the finals (S, Q)."""
    rank_ext, rank_uni = lay.state_ranks()
    fs_off = np.full(lay.S, -2, np.int32)
    for fi, s in enumerate(lay.fin_states):
        fs_off[s] = lay.off_fs[fi]
    init = np.zeros(lay.S, np.int32)
    init[list(lay.init_states)] = 1
    finals = (np.asarray(finals_sq) > 0).astype(np.int32).reshape(-1)
    return np.concatenate([
        rank_ext.ravel(), rank_uni.ravel(), np.asarray(lay.off_ext),
        np.asarray(lay.off_uni),
        [len(x) for x in lay.ext_states], [len(x) for x in lay.uni_states],
        fs_off, init, finals]).astype(np.int32)


def check_launchable(lay: ArenaBlockLayout, steps: int) -> None:
    """Raise ``ValueError`` for what the kernel does not take."""
    if not 1 <= lay.S <= MAX_STATES:
        raise ValueError(f"arena_update takes 1..{MAX_STATES} det states, "
                         f"got {lay.S}")
    if not 1 <= lay.Q <= MAX_QUERIES:
        raise ValueError(f"arena_update takes 1..{MAX_QUERIES} queries per "
                         f"launch, got {lay.Q}")
    if lay.voffset + steps * lay.M > INT32_MAX:
        raise ValueError(
            f"virtual node ids overflow int32: voffset {lay.voffset} + "
            f"steps {steps} × M {lay.M} > {INT32_MAX}; shorten the chunk "
            "or the capacity")


class ArenaUpdateKernel:
    """The kernel's binding and its launch counter.

    ``launches`` counts kernel launches (one per :meth:`__call__`).
    """

    def __init__(self):
        self.launches = 0
        self._lib = None

    def library(self) -> ctypes.CDLL:
        """The shared library, with this kernel's entry point bound."""
        if self._lib is None:
            lib = LIBRARY.get()
            lib.arena_update_launch.restype = _I
            lib.arena_update_launch.argtypes = (
                [_P] * 18 + [_I] + [_P] * 4 + [_I] * 10 + [_P])
            self._lib = lib
        return self._lib

    def __call__(self, cells0: Sequence[torch.Tensor],
                 xs: Sequence[torch.Tensor], *, lay: ArenaBlockLayout,
                 ptab: torch.Tensor, finals_sq,
                 expire: Optional[torch.Tensor] = None,
                 consume: Optional[torch.Tensor] = None):
        """Launch on one chunk of segmented operands.

        cells0: four (B', W, S) int32 cell tables; xs: ``(cls, hit, j,
        live, vbase)`` step-major int32 operands — (steps, B') and hit
        (steps, B', Q); expire (steps, B', W) and consume (steps, B', S)
        optional; ptab (C, S, K, 3) int32; finals_sq (S, Q).  Returns
        ``(cells_fin, (valid, left, right), roots)``: the final cell table,
        the lane-major record rows (B', steps, M) and roots (B', steps, Q).
        Raises ``ValueError`` on what the kernel does not take.
        """
        cls, hit, j, live, vb = xs
        steps, Bn = cls.shape
        W, S, Q, M = lay.W, lay.S, lay.Q, lay.M
        check_launchable(lay, steps)
        C = ptab.shape[0]
        operands = {
            "cls": (cls, (steps, Bn)), "hit": (hit, (steps, Bn, Q)),
            "j": (j, (steps, Bn)), "live": (live, (steps, Bn)),
            "vbase": (vb, (steps, Bn)), "ptab": (ptab, (C, S, lay.K, 3)),
        }
        for i, c in enumerate(cells0):
            operands[f"cells0[{i}]"] = (c, (Bn, W, S))
        if expire is not None:
            operands["expire"] = (expire, (steps, Bn, W))
        if consume is not None:
            operands["consume"] = (consume, (steps, Bn, S))
        dev = cls.device
        for name, (t, shape) in operands.items():
            if t.device != dev or dev.type != "cuda":
                raise ValueError(f"arena_update operand {name} is on "
                                 f"{t.device}; every operand must be on "
                                 f"{dev} (CUDA)")
            if t.dtype != torch.int32 or tuple(t.shape) != shape:
                raise ValueError(f"arena_update operand {name} must be int32 "
                                 f"{shape}, got {t.dtype} {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"arena_update operand {name} must be "
                                 "contiguous")

        def full(shape, value):
            return torch.full(shape, value, dtype=torch.int32, device=dev)

        with torch.cuda.device(dev):
            lib = self.library()
            tabs = torch.from_numpy(layout_table(lay, finals_sq)).to(dev)
            cells = [c.clone() for c in cells0]
            alt = [torch.empty_like(c) for c in cells]
            sa = torch.empty((Bn, W, Q), dtype=torch.int32, device=dev)
            valid = full((Bn, steps, M), 0)
            left = full((Bn, steps, M), ARENA_NULL)
            right = full((Bn, steps, M), ARENA_NULL)
            roots = full((Bn, steps, Q), ARENA_NULL)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.arena_update_launch(
                *(c.data_ptr() for c in cells), *(c.data_ptr() for c in alt),
                sa.data_ptr(), cls.data_ptr(), hit.data_ptr(), j.data_ptr(),
                live.data_ptr(), vb.data_ptr(), _ptr(expire), _ptr(consume),
                ptab.data_ptr(), tabs.data_ptr(), int(tabs.numel()),
                valid.data_ptr(), left.data_ptr(), right.data_ptr(),
                roots.data_ptr(), Bn, steps, W, S, lay.K, Q, M,
                lay.epsilon, lay.off_bottom, lay.off_chain, stream)
        if err != 0:
            raise RuntimeError(f"arena_update launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return tuple(cells), (valid, left, right), roots


#: the process's kernel binding
KERNEL = ArenaUpdateKernel()
