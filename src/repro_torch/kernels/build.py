"""One shared library for every Hopper kernel of the port.

Each CUDA source in ``csrc/`` is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a``, and the objects are linked into one shared
library in ``build/repro_torch/`` at the repository root, named by a hash of
the sources, every header in ``csrc/`` and the flags.  The library is built and
loaded at first use, once per process, and bound through ``ctypes``; nothing
happens at import.
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

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "fused_scan.cu", CSRC / "arena_update.cu",
           CSRC / "bitvector.cu", CSRC / "cea_scan.cu",
           CSRC / "lane_route.cu")
#: every header in ``csrc/``: part of the library's hash, so an edit to any
#: header a source includes rebuilds the library
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       f"{CSRC} at first use and need the CUDA toolkit")


class KernelLibrary:
    """The built library and its counters.

    ``loads`` counts builds or loads of the library (1 per process);
    ``build_log`` keeps nvcc's register and spill report (``-Xptxas -v``)
    of every source; ``build_seconds`` the time to build (or find) and
    load it.
    """

    def __init__(self):
        self.loads = 0
        self.build_seconds = 0.0
        self.build_log = ""
        self._lib = None

    def get(self) -> ctypes.CDLL:
        """Build (if a source changed) and load the library, once."""
        if self._lib is not None:
            return self._lib
        t0 = time.perf_counter()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in SOURCES + HEADERS:
            h.update(src.name.encode() + src.read_bytes())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"
        if not lib_path.exists():
            self._build(lib_path)
        self._lib = ctypes.CDLL(str(lib_path))
        self.loads += 1
        self.build_seconds = time.perf_counter() - t0
        return self._lib

    def _build(self, lib_path: Path) -> None:
        tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        try:
            nvcc = _nvcc()
            objs = [tmp / (src.stem + ".o") for src in SOURCES]
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for src, obj in zip(SOURCES, objs)]
            logs = []
            for src, proc in zip(SOURCES, procs):
                out, err = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src}:\n{err}")
                logs.append(f"== {src.name}\n{out}{err}")
            so = tmp / "lib.so"
            proc = subprocess.run(
                [nvcc, "-shared", "-o", str(so), *map(str, objs)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to link:\n{proc.stderr}")
            os.replace(so, lib_path)
            self.build_log = "".join(logs)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


#: the process's library: one load serves every kernel and engine
LIBRARY = KernelLibrary()
