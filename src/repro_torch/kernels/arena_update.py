"""Wrappers and launch counters of the Hopper block tECS builder kernel.

The kernel (``csrc/arena_update.cu``) replaces the TPU kernel
``src/repro/kernels/arena_update.py:arena_update_pallas``.  It has two
routes that share one fold:

* :data:`KERNEL` (the store route, the engines' main path): allocates node
  ids itself and writes the node store, cell table, pointer, overflow latch
  and roots in real ids.  Plain version: :func:`repro_torch.kernels.ref.
  arena_store_ref`.
* :data:`DENSE` (segmented chunks): the TPU kernel's contract, dense
  ``(B', steps, M)`` records on virtual ids.  Plain version:
  :func:`repro_torch.kernels.ref.arena_build_ref`.

It lives in the port's one kernel library (:mod:`repro_torch.kernels.
build`), built with ``nvcc`` for ``sm_90a`` at first use and bound through
``ctypes``.  Nothing is built or loaded when this module is imported.  Use
the routers :func:`repro_torch.kernels.ops.arena_store_update` and
:func:`repro_torch.kernels.ops.arena_block_update`, which send CUDA tensors
here and CPU tensors to the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from .build import LIBRARY
from .ref import ARENA_NULL, ArenaBlockLayout

MAX_STATES = 512   # the reference's MAX_DET_STATES
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


def _device_table(lay: ArenaBlockLayout, finals_sq, dev) -> torch.Tensor:
    """:func:`layout_table` on ``dev``, built once per (layout, finals,
    device) and cached on the layout."""
    cache = getattr(lay, "_device_tables", None)
    if cache is None:
        cache = {}
        object.__setattr__(lay, "_device_tables", cache)
    fin = (np.asarray(finals_sq) > 0)
    key = (str(dev), fin.shape, fin.tobytes())
    if key not in cache:
        cache[key] = torch.from_numpy(layout_table(lay, fin)).to(dev)
    return cache[key]


def _words(n: int) -> int:
    return (n + 31) // 32


def smem_bytes(lay: ArenaBlockLayout, store: bool = False) -> int:
    """Dynamic shared memory of a launch, int32 words: the layout tables,
    one step's predecessor table (S·K·3), its clear mask (S) and hits (Q),
    six W-bit bitmaps (occupancy and dirtiness of both cell buffers, the
    slots folded this step and the step's candidates), the (W,) candidate
    list, a block scan's eight warp totals and the list's length and, for
    up to 12 states, each thread's staged pre-fold row (4·S ints of 256
    threads); the store route adds the (W,) slot-start table and the M-bit
    allocation bitmap with its word prefix."""
    S, K, Q, W = lay.S, lay.K, lay.Q, lay.W
    ntab = 2 * K * S + 4 * K + 2 * S + S * Q     # layout_table's length
    stage = 4 * S * 256 if S <= 12 else 0
    n = ntab + S * K * 3 + S + Q + 6 * _words(W) + W + 9 + stage
    if store:
        n += W + 2 * _words(lay.M)
    return 4 * n


def check_launchable(lay: ArenaBlockLayout, steps: int,
                     smem_limit: Optional[int] = None,
                     store: bool = False) -> None:
    """Raise ``ValueError`` for what the kernel does not take;
    ``smem_limit`` is the card's dynamic shared memory per block.  The
    dense route's virtual ids must fit int32; the store route has none."""
    if not 1 <= lay.S <= MAX_STATES:
        raise ValueError(f"arena_update takes 1..{MAX_STATES} det states "
                         f"(the reference's MAX_DET_STATES), got {lay.S}")
    if lay.Q < 1:
        raise ValueError(f"arena_update needs at least one query, got "
                         f"{lay.Q}")
    if lay.W < lay.E:
        raise ValueError(f"arena_update needs a ring of at least epsilon+1 "
                         f"slots, got W={lay.W} for epsilon={lay.epsilon}")
    need = smem_bytes(lay, store)
    if smem_limit is not None and need > smem_limit:
        raise ValueError(
            f"arena_update's {'store' if store else 'dense'} route takes "
            f"{need} bytes of shared memory (layout tables, bitmaps"
            f"{', M-bit allocation bitmap and start table' if store else ''}"
            f"; S={lay.S}, K={lay.K}, Q={lay.Q}, W={lay.W}, M={lay.M}), "
            f"above the card's {smem_limit}")
    if not store and lay.voffset + steps * lay.M > INT32_MAX:
        raise ValueError(
            f"virtual node ids overflow int32: voffset {lay.voffset} + "
            f"steps {steps} × M {lay.M} > {INT32_MAX}; shorten the chunk "
            "or the capacity")


def _check_operands(operands: dict, dev) -> None:
    for name, (t, shape, dtype) in operands.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"arena_update operand {name} is on "
                             f"{t.device}; every operand must be on "
                             f"{dev} (CUDA)")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"arena_update operand {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"arena_update operand {name} must be "
                             "contiguous")


class _Binding:
    """The library's arena entry points and the card's shared memory."""

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._smem_limit = None

    def library(self) -> ctypes.CDLL:
        """The shared library, with this kernel's entry points bound."""
        if self._lib is None:
            lib = LIBRARY.get()
            lib.arena_update_launch.restype = _I
            lib.arena_update_launch.argtypes = (
                [_P] * 18 + [_I] + [_P] * 4 + [_I] * 10 + [_P])
            lib.arena_store_launch.restype = _I
            lib.arena_store_launch.argtypes = (
                [_P] * 17 + [_I] + [_P] * 10 + [_I] * 11 + [_P])
            lib.arena_update_max_dynamic_smem.restype = _I
            lib.arena_update_max_dynamic_smem.argtypes = [ctypes.POINTER(_I)]
            self._lib = lib
        return self._lib

    def smem_limit(self) -> int:
        """Dynamic shared memory a block may use on the current card."""
        if self._smem_limit is None:
            out = _I(0)
            err = self.library().arena_update_max_dynamic_smem(
                ctypes.byref(out))
            if err != 0:
                raise RuntimeError(f"arena_update_max_dynamic_smem failed: "
                                   f"CUDA error {err}")
            self._smem_limit = out.value
        return self._smem_limit


def _step_operands(xs, cells0, lay: ArenaBlockLayout, ptab, expire,
                   consume) -> dict:
    cls = xs[0]
    steps, Bn = cls.shape
    W, S, Q = lay.W, lay.S, lay.Q
    i32 = torch.int32
    ops = {"cls": (cls, (steps, Bn), i32), "hit": (xs[1], (steps, Bn, Q), i32),
           "j": (xs[2], (steps, Bn), i32), "live": (xs[3], (steps, Bn), i32),
           "ptab": (ptab, (ptab.shape[0], S, lay.K, 3), i32)}
    for i, c in enumerate(cells0):
        ops[f"cells0[{i}]"] = (c, (Bn, W, S), i32)
    if expire is not None:
        ops["expire"] = (expire, (steps, Bn, W), i32)
    if consume is not None:
        ops["consume"] = (consume, (steps, Bn, S), i32)
    return ops


class ArenaStoreKernel(_Binding):
    """The store route's binding and its launch counter (one per
    :meth:`__call__`)."""

    def __call__(self, arena: dict, cells0: Sequence[torch.Tensor],
                 sstart0: torch.Tensor, xs: Sequence[torch.Tensor],
                 gpos: torch.Tensor, *, lay: ArenaBlockLayout,
                 ptab: torch.Tensor, finals_sq,
                 expire: Optional[torch.Tensor] = None,
                 consume: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Launch on one chunk; updates ``arena`` in place.

        arena: the node store dict (``kind/pos/maxs/left/right`` (B,
        cap+1) int32, ``cell`` (B, W, S) int32, ``ptr`` (B,) int32, ``ovf``
        (B,) bool).  cells0: the four (B, W, S) int32 chunk-start cell
        tables, ``cells0[0]`` the arena's ``cell`` (the kernel writes the
        final ids there; the other three are scratch it overwrites);
        sstart0: (B, W) int32 slot starts; xs: ``(cls, hit, j, live)``
        step-major int32 operands, (T, B) and hit (T, B, Q); gpos (T, B)
        int32; expire (T, B, W) and consume (T, B, S) optional; ptab (C, S,
        K, 3) int32; finals_sq (S, Q).  Returns roots (B, T, Q) in real
        ids, NULL where no root was built.  Raises ``ValueError`` on what
        the kernel does not take.
        """
        cls, hit, j, live = xs
        T, B = cls.shape
        W, S, Q, cap = lay.W, lay.S, lay.Q, lay.cap
        check_launchable(lay, T, store=True)
        if cells0[0] is not arena["cell"]:
            raise ValueError("arena_update's store route takes the arena's "
                             "own cell tensor as cells0[0]")
        operands = _step_operands(xs, cells0, lay, ptab, expire, consume)
        operands["gpos"] = (gpos, (T, B), torch.int32)
        operands["sstart0"] = (sstart0, (B, W), torch.int32)
        for name in ("kind", "pos", "maxs", "left", "right"):
            operands[name] = (arena[name], (B, cap + 1), torch.int32)
        operands["ptr"] = (arena["ptr"], (B,), torch.int32)
        operands["ovf"] = (arena["ovf"], (B,), torch.bool)
        dev = cls.device
        _check_operands(operands, dev)
        with torch.cuda.device(dev):
            check_launchable(lay, T, self.smem_limit(), store=True)
            lib = self.library()
            tabs = _device_table(lay, finals_sq, dev)
            alt = [torch.empty_like(c) for c in cells0]
            sa = torch.empty((B, W, Q), dtype=torch.int32, device=dev)
            roots = torch.full((B, T, Q), ARENA_NULL, dtype=torch.int32,
                               device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.arena_store_launch(
                *(c.data_ptr() for c in cells0),
                *(c.data_ptr() for c in alt), sa.data_ptr(),
                cls.data_ptr(), hit.data_ptr(), j.data_ptr(),
                live.data_ptr(), _ptr(expire), _ptr(consume),
                ptab.data_ptr(), tabs.data_ptr(), int(tabs.numel()),
                gpos.data_ptr(), sstart0.data_ptr(),
                *(arena[n].data_ptr() for n in
                  ("kind", "pos", "maxs", "left", "right")),
                arena["ptr"].data_ptr(), arena["ovf"].data_ptr(),
                roots.data_ptr(), B, T, W, S, lay.K, Q, lay.M, lay.epsilon,
                lay.off_bottom, lay.off_chain, cap, stream)
        if err != 0:
            raise RuntimeError(f"arena_update store launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return roots


class ArenaDenseKernel(_Binding):
    """The dense route's binding and its launch counter (one per
    :meth:`__call__`)."""

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
        operands = _step_operands(xs, cells0, lay, ptab, expire, consume)
        operands["vbase"] = (vb, (steps, Bn), torch.int32)
        dev = cls.device
        _check_operands(operands, dev)

        def full(shape, value):
            return torch.full(shape, value, dtype=torch.int32, device=dev)

        with torch.cuda.device(dev):
            check_launchable(lay, steps, self.smem_limit())
            lib = self.library()
            tabs = _device_table(lay, finals_sq, dev)
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


#: the store route's binding (the engines' main path)
KERNEL = ArenaStoreKernel()
#: the dense route's binding (segmented chunks, the TPU kernel's contract)
DENSE = ArenaDenseKernel()
