"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``: every pointer and
the stream cross as ``c_void_p``. A library is named after the hash of its
source and of the shared headers (``csrc/*.cuh``), so an edited source or
header rebuilds and an unchanged one loads the library already built. The build goes to ``build/repro_torch_kernels/`` at the root
of the checkout, at first use. A failed build raises with nvcc's output.

Nothing here runs at import: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_FNS: Dict[str, ctypes._CFuncPtr] = {}
#: seconds each source took to compile in this process (0.0: found built)
BUILD_SECONDS: Dict[str, float] = {}
#: nvcc's report per source (``-Xptxas -v``: registers, shared memory, spills)
PTXAS: Dict[str, str] = {}


class LaunchCount:
    """Launches of one kernel, counted by its wrapper where it launches it."""

    def __init__(self) -> None:
        self.n = 0


class KernelError(RuntimeError):
    """A kernel did not build, or its launch returned a CUDA error."""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source not yet built, all nvcc processes started
    together, and wait for them. Returns each library's path."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            BUILD_SECONDS.setdefault(name, 0.0)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        PTXAS[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelError("nvcc failed:\n" + "\n".join(failed))
    return {name: _target(name) for name in names}


def function(name: str, argtypes: List[type]) -> ctypes._CFuncPtr:
    """The C entry ``name`` of ``csrc/<name>.cu`` (built and loaded at first
    use), returning an ``int`` CUDA error code."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(ctypes.CDLL(str(build([name])[name])), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FNS[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise when a C entry returned a CUDA error code (non-zero)."""
    if rc != 0:
        raise KernelError(f"{name}: CUDA error {rc} at launch")
