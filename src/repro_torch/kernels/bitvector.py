"""Wrapper and launch counter of the Hopper bit-vector kernel.

The kernel (``csrc/bitvector.cu``) replaces the TPU kernel
``src/repro/kernels/bitvector.py:bitvector_pallas``: k predicate specs
``(column, op, threshold)`` over ``(N, A)`` f32 attributes → ``(N,)`` int32
packed bits.  It lives in the port's one kernel library
(:mod:`repro_torch.kernels.build`), built at first use; nothing is built or
loaded when this module is imported.

Use :func:`repro_torch.kernels.ops.bitvector`, which routes CUDA tensors
here and CPU tensors to the plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .build import LIBRARY

MAX_BITS = 31   # bits of a non-negative int32
N_OPS = 6       # EQ, NE, LT, LE, GT, GE

_P = ctypes.c_void_p
_I = ctypes.c_int


class BitvectorKernel:
    """The kernel's binding and its launch counter.

    ``launches`` counts kernel launches (one per :meth:`__call__` with
    N > 0).
    """

    def __init__(self):
        self.launches = 0
        self._lib = None

    def library(self) -> ctypes.CDLL:
        """The shared library, with this kernel's entry point bound."""
        if self._lib is None:
            lib = LIBRARY.get()
            lib.bitvector_launch.restype = _I
            lib.bitvector_launch.argtypes = [_P, _P, _P, _P, _I, _P,
                                             ctypes.c_longlong, _I, _P]
            self._lib = lib
        return self._lib

    def __call__(self, attrs: torch.Tensor,
                 specs: Sequence[Tuple[int, int, float]]) -> torch.Tensor:
        """attrs (N, A) f32 on CUDA, contiguous → bits (N,) int32.

        Raises ``ValueError`` on what the kernel does not take.
        """
        check_specs(specs, attrs)
        if attrs.device.type != "cuda":
            raise ValueError(f"bitvector kernel operand attrs is on "
                             f"{attrs.device}; it must be on CUDA")
        if attrs.dtype != torch.float32 or not attrs.is_contiguous():
            raise ValueError(f"bitvector kernel takes contiguous f32 attrs, "
                             f"got {attrs.dtype}")
        N, A = attrs.shape
        k = len(specs)
        dev = attrs.device
        with torch.cuda.device(dev):
            bits = torch.empty((N,), dtype=torch.int32, device=dev)
            if N == 0:
                return bits
            lib = self.library()
            err = lib.bitvector_launch(
                attrs.data_ptr(),
                (_I * max(k, 1))(*[int(s[0]) for s in specs]),
                (_I * max(k, 1))(*[int(s[1]) for s in specs]),
                (ctypes.c_float * max(k, 1))(*[float(s[2]) for s in specs]),
                k, bits.data_ptr(), N, A,
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"bitvector launch failed: CUDA error {err}")
        self.launches += 1
        return bits


def check_specs(specs: Sequence[Tuple[int, int, float]],
                attrs: torch.Tensor) -> None:
    """Raise ``ValueError`` for specs or attributes the kernel refuses."""
    if attrs.ndim != 2 or attrs.shape[1] < 1:
        raise ValueError(f"bitvector takes (N, A ≥ 1) attributes, got "
                         f"{tuple(attrs.shape)}")
    if len(specs) > MAX_BITS:
        raise ValueError(f"bitvector packs at most {MAX_BITS} predicates "
                         f"into an int32, got {len(specs)}")
    A = attrs.shape[1]
    for col, op, _ in specs:
        if not 0 <= int(col) < A:
            raise ValueError(f"a predicate reads column {col} outside A={A}")
        if not 0 <= int(op) < N_OPS:
            raise ValueError(f"unknown predicate op code {op}")


#: the process's kernel: one library load serves every engine
KERNEL = BitvectorKernel()
