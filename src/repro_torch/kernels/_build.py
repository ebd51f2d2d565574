"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded through ctypes: pointers and the
stream go in as ``c_void_p``, sizes as ``c_int``, and every launcher
returns the ``cudaError_t`` of its launch.  Libraries land in
``build/repro_torch_kernels/`` at the repository root (``build/`` is
git-ignored), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads from disk.  ``build()``
starts one ``nvcc`` per missing source, all at once, and waits for them.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.  ``--use_fast_math`` is never passed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: kernel sources, one shared library each
SOURCES = ("pac_eval", "fused_step")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES, *, verbose: bool = False) -> dict:
    """Compile every missing library of `names` in parallel.  Returns
    {name: seconds spent compiling it} (0.0 for one already on disk);
    raises with nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, secs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.monotonic())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.monotonic() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        if verbose and log:
            print(log, end="")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def function(name: str, symbol: str, argtypes):
    """The ctypes function `symbol` of library `name` (built on first
    use), with argtypes set and an int (cudaError_t) return."""
    with _lock:
        key = (name, symbol)
        fn = _libs.get(key)
        if fn is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _libs[key] = fn
        return fn


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
