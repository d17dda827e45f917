"""Wrapper, build and launch counter of the Hopper fused-scan kernel.

The kernel (``csrc/fused_scan.cu``) replaces the TPU kernel
``src/repro/kernels/fused_scan.py:fused_scan_pallas``.  It is compiled with
``nvcc`` for ``sm_90a`` at first use, from the source in this package, into
``build/repro_torch/`` at the repository root, and bound through ``ctypes``.
Nothing is built or loaded when this module is imported.

Use :func:`repro_torch.kernels.ops.cer_pipeline`, which routes CUDA tensors
here and CPU tensors to the plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_scan.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_BITS = 14       # predicates per query
MAX_QUERIES = 8     # queries per launch
MAX_THREADS = 256
_STATE_BUCKETS = (8, 16, 32)  # det-state template instantiations
MAX_STATES = _STATE_BUCKETS[-1]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the fused-scan kernel is built from "
                       f"{SOURCE} at first use and needs the CUDA toolkit")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class FusedScanKernel:
    """The built library and its counters.

    ``launches`` counts kernel launches (one per :meth:`__call__`);
    ``loads`` counts builds or loads of the library (1 per process);
    ``build_log`` keeps nvcc's register and spill report (``-Xptxas -v``).
    """

    def __init__(self):
        self.launches = 0
        self.loads = 0
        self.build_seconds = 0.0
        self.build_log = ""
        self._lib = None
        self._smem_limit = {}

    # ------------------------------------------------------------------
    def library(self) -> ctypes.CDLL:
        """Build (if the source changed) and load the library, once."""
        if self._lib is not None:
            return self._lib
        t0 = time.perf_counter()
        src = SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"libfused_scan_{digest}.so"
        if not lib_path.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {SOURCE}:\n{proc.stderr}")
                self.build_log = proc.stderr
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(lib_path))
        lib.fused_scan_launch.restype = _I
        lib.fused_scan_launch.argtypes = (
            [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _P, _P, _P] + [_I] * 7 + [ctypes.c_float] + [_I] * 4 + [_P])
        lib.fused_scan_max_dynamic_smem.restype = _I
        lib.fused_scan_max_dynamic_smem.argtypes = [_I, ctypes.POINTER(_I)]
        self._lib = lib
        self.loads += 1
        self.build_seconds = time.perf_counter() - t0
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
                 return_trace: bool = False):
        """Launch on one chunk.  Updates ``c`` (and ``ts_ring``/``ovf`` for
        time windows) in place; returns ``matches (T, B, NQ)`` f32 and, with
        ``return_trace``, the ``(T, B)`` int32 class trace.

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

        max_s = next(m for m in _STATE_BUCKETS if S <= m)
        threads = min(MAX_THREADS, max(32, -(-W // 32) * 32))
        ring_bytes = (W * (S | 1) + (W if timed else 0)) * 4
        with torch.cuda.device(dev):
            lib = self.library()
            use_smem = ring_bytes <= self.smem_limit(max_s)
            matches = torch.empty((T, B, NQ), dtype=torch.float32,
                                  device=dev)
            trace = (torch.empty((T, B), dtype=torch.int32, device=dev)
                     if return_trace else None)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fused_scan_launch(
                attrs.data_ptr(),
                (_I * max(k, 1))(*[int(s[0]) for s in specs]),
                (_I * max(k, 1))(*[int(s[1]) for s in specs]),
                (ctypes.c_float * max(k, 1))(*[float(s[2]) for s in specs]),
                k, class_of.data_ptr(), m_all.data_ptr(),
                finals_q.data_ptr(), init_mask.data_ptr(), _ptr(latest_q),
                _ptr(consume_sq), c.data_ptr(), _ptr(ts_ring), _ptr(ovf),
                _ptr(event_ts), start.data_ptr(), valid.data_ptr(),
                matches.data_ptr(), _ptr(trace), T, B, A, S, NQ, W,
                int(epsilon), ctypes.c_float(time_size if timed else 0.0),
                int(timed), max_s, threads, int(use_smem), stream)
        if err != 0:
            raise RuntimeError(f"fused_scan launch failed: CUDA error {err}")
        self.launches += 1
        return (matches, trace) if return_trace else matches


def check_launchable(*, T: int, B: int, S: int, NQ: int, k: int, W: int,
                     epsilon: int, timed: bool) -> None:
    """Raise ``ValueError`` for shapes the kernel does not take."""
    if k > MAX_BITS:
        raise ValueError(f"fused_scan takes at most {MAX_BITS} predicates, "
                         f"got {k}")
    if not 1 <= NQ <= MAX_QUERIES:
        raise ValueError(f"fused_scan takes 1..{MAX_QUERIES} queries per "
                         f"launch, got {NQ}")
    if not 1 <= S <= MAX_STATES:
        raise ValueError(f"fused_scan takes 1..{MAX_STATES} det states, got "
                         f"{S}")
    if B < 1 or T < 0:
        raise ValueError(f"fused_scan needs B ≥ 1 and T ≥ 0, got B={B} "
                         f"T={T}")
    if not timed and W < epsilon + 1:
        raise ValueError(f"ring {W} < epsilon+1 ({epsilon + 1})")
    if W * S >= 2 ** 31:
        raise ValueError(f"fused_scan ring W·S must stay below 2^31, got "
                         f"{W}·{S}")


#: the process's kernel: one library load serves every engine
KERNEL = FusedScanKernel()
