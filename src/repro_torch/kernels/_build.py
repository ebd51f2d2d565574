"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded through ctypes: pointers and the
stream go in as ``c_void_p``, sizes as ``c_int``, and every launcher
returns the ``cudaError_t`` of its launch.  Libraries land in
``build/repro_torch_kernels/`` at the repository root (``build/`` is
git-ignored), named by a hash of the source, the ``csrc/`` headers it
includes and the flags, so an edited source or header rebuilds and an
unchanged one loads from disk.  nvcc gets ``-I csrc/``, so the copies that
``start_variants`` writes elsewhere find the same headers.  ``build()``
starts one ``nvcc`` per missing source, all at once, and waits for them.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.  ``--use_fast_math`` is never passed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
#: devices whose tensors the model kernels' wrappers give to the plain
#: versions: the CPU, and meta (shapes only: the dry run's traced step)
PLAIN_DEVICES = ("cpu", "meta")

#: kernel sources, one shared library each
SOURCES = ("downtime_eval", "fused_downtime", "latency_charge",
           "mlstm_chunk", "rglru_scan", "flash_attention",
           "flash_attention_sm90", "mlstm_chunk_sm90", "microsim_scan",
           "rglru_scan_bwd", "mlstm_chunk_bwd", "mlstm_chunk_bwd_sm90")

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_headers(text: bytes) -> list:
    """The csrc/ headers that `text` includes with quotes, and theirs, in
    the order first met."""
    found, todo = [], [text]
    while todo:
        for inc in _INCLUDE.findall(todo.pop()):
            path = CSRC / inc.decode()
            if path.exists() and path not in found:
                found.append(path)
                todo.append(path.read_bytes())
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src)
    for header in local_headers(src):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc(out, src, *, verbose=False):
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC)]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    return subprocess.Popen(cmd + ["-o", str(out), str(src)],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(names=SOURCES, *, verbose: bool = False, logs=None) -> dict:
    """Compile every missing library of `names` in parallel.  Returns
    {name: seconds spent compiling it} (0.0 for one already on disk);
    raises with nvcc's output if any compile fails.  With `verbose`, nvcc
    runs with ``-Xptxas -v`` and its output is printed and, when `logs`
    is a dict, kept there by name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, secs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (_nvcc(tmp, CSRC / f"{name}.cu", verbose=verbose),
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
            if logs is not None:
                logs[name] = log
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


def start_variants(name: str, faults: dict, out_dir: Path, *,
                   with_source: bool = True) -> dict:
    """Start nvcc, without waiting, on one copy of csrc/<name>.cu per
    planted fault (and, with `with_source`, on the unchanged file as
    "source"), into `out_dir`.  `faults` maps a fault's name to (text,
    replacement), or to a list of such pairs, each text occurring once in
    the source.  Returns the handle ``finish_variants`` takes."""
    src = (CSRC / f"{name}.cu").read_text()
    texts = {"source": src} if with_source else {}
    for fault, edits in faults.items():
        text = src
        for old, new in [edits] if isinstance(edits[0], str) else edits:
            if src.count(old) != 1:
                raise RuntimeError(f"fault {fault}: {old!r} occurs "
                                   f"{src.count(old)} times in {name}.cu")
            text = text.replace(old, new)
        texts[fault] = text
    procs = {}
    for variant, text in texts.items():
        cu = out_dir / f"{name}-{variant}.cu"
        so = out_dir / f"lib{name}-{variant}.so"
        cu.write_text(text)
        procs[variant] = (_nvcc(so, cu), so)
    return procs


def finish_variants(procs: dict, symbol, argtypes) -> dict:
    """Wait for ``start_variants``' builds; returns {variant: the ctypes
    function `symbol` of its library}, or a tuple of them when `symbol`
    is a tuple of names; `argtypes` is then one list for all of them, or
    a tuple of lists, one per name.  Raises with nvcc's output if a build
    fails."""
    symbols = (symbol,) if isinstance(symbol, str) else tuple(symbol)
    per_symbol = isinstance(argtypes[0], (list, tuple))
    fns = {}
    for variant, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {variant}:\n{log}")
        lib = ctypes.CDLL(str(so))
        found = []
        for i, sym in enumerate(symbols):
            fn = getattr(lib, sym)
            fn.argtypes = list(argtypes[i] if per_symbol else argtypes)
            fn.restype = ctypes.c_int
            found.append(fn)
        fns[variant] = found[0] if isinstance(symbol, str) else tuple(found)
    return fns


def launcher_argtypes(text: str, symbol: str) -> tuple:
    """The ctypes argtypes of the C launcher `symbol` as the source `text`
    declares it: c_void_p for each pointer and the stream, c_int for each
    int."""
    m = re.search(r"int " + symbol + r"\((.*?)\)", text, re.S)
    if m is None:
        raise ValueError(f"no launcher {symbol} in the source")
    return tuple(ctypes.c_void_p if "*" in prm else ctypes.c_int
                 for prm in m.group(1).split(","))


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
