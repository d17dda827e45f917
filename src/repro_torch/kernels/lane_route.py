"""Wrapper and launch counter of the Hopper lane-routing kernel.

The kernel (``csrc/lane_route.cu``) replaces the lane assignment of the
reference's partitioned engine (``src/repro/vector/partitioned.py``,
``_part_step_impl``'s ``assign``, a ``jax.lax.scan`` rather than a Pallas
kernel): one chunk's partition keys against the ``(L,)`` lane table → each
event's lane and rank within it, and the new lane table.  It lives in the
port's one kernel library (:mod:`repro_torch.kernels.build`), built at first
use; nothing is built or loaded when this module is imported.

Use :func:`repro_torch.kernels.ops.lane_route`, which routes CUDA tensors
here and CPU tensors to :func:`repro_torch.kernels.ref.lane_route_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from .build import LIBRARY
from .ref import EVICT_POLICIES, LaneRoute

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


class LaneRouteKernel:
    """The kernel's binding and its launch counter.

    ``launches`` counts router launches: one per :meth:`__call__` (one C
    entry point that queues the route's kernels on the current stream).
    """

    def __init__(self):
        self.launches = 0
        self._lib = None

    def library(self) -> ctypes.CDLL:
        """The shared library, with this kernel's entry points bound."""
        if self._lib is None:
            lib = LIBRARY.get()
            lib.lane_route_scratch_bytes.restype = _LL
            lib.lane_route_scratch_bytes.argtypes = [_I, _I]
            lib.lane_route_launch.restype = _I
            lib.lane_route_launch.argtypes = (
                [_P, _P, _P, _I, _I, _I] + [_P] * 8 + [_LL, _I, _I, _P])
            self._lib = lib
        return self._lib

    def __call__(self, keys: torch.Tensor, lane_keys: torch.Tensor,
                 lane_last: torch.Tensor, *, chunk_idx: int, cap: int,
                 evict: str) -> LaneRoute:
        """keys (T,) and lane_keys (L,) int32 key bits, lane_last (L,)
        int32, all contiguous on one CUDA device → :class:`LaneRoute`.

        Raises ``ValueError`` on what the kernel does not take.
        """
        if evict not in EVICT_POLICIES:
            raise ValueError(f"evict must be one of {EVICT_POLICIES}, got "
                             f"{evict!r}")
        for name, t in (("keys", keys), ("lane_keys", lane_keys),
                        ("lane_last", lane_last)):
            if t.device.type != "cuda" or t.device != keys.device:
                raise ValueError(f"lane_route operand {name} is on "
                                 f"{t.device}; all must be on one CUDA "
                                 "device")
            if t.dtype != torch.int32 or t.ndim != 1 or \
                    not t.is_contiguous():
                raise ValueError(f"lane_route takes contiguous 1-D int32 "
                                 f"{name}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
        T, L = keys.shape[0], lane_keys.shape[0]
        if T < 1 or L < 1 or lane_last.shape[0] != L:
            raise ValueError(f"lane_route takes T ≥ 1 keys and (L ≥ 1,) "
                             f"lane tables, got T={T}, lane_keys {L}, "
                             f"lane_last {lane_last.shape[0]}")
        if not 1 <= int(cap) < 2 ** 31 or T + L >= 2 ** 30:
            raise ValueError(f"lane_route takes 1 ≤ cap < 2^31 and "
                             f"T + L < 2^30, got cap={cap}, T={T}, L={L}")
        dev = keys.device
        with torch.cuda.device(dev):
            lib = self.library()
            nbytes = int(lib.lane_route_scratch_bytes(T, L))
            scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)

            def new(n, dtype=torch.int32):
                return torch.empty((n,), dtype=dtype, device=dev)
            out = LaneRoute(lane=new(T), rank=new(T),
                            null=new(T, torch.bool), lane_keys=new(L),
                            lane_last=new(L), evicted=new(L, torch.bool),
                            fill=new(L))
            err = lib.lane_route_launch(
                keys.data_ptr(), lane_keys.data_ptr(), lane_last.data_ptr(),
                int(chunk_idx), int(cap), int(evict == "lru"),
                out.lane.data_ptr(), out.rank.data_ptr(),
                out.null.data_ptr(), out.lane_keys.data_ptr(),
                out.lane_last.data_ptr(), out.evicted.data_ptr(),
                out.fill.data_ptr(), scratch.data_ptr(), nbytes, T, L,
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"lane_route launch failed: CUDA error {err}")
        self.launches += 1
        return out


#: the process's kernel: one library load serves every engine
KERNEL = LaneRouteKernel()
