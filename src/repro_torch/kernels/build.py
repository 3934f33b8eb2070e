"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` file exposes a plain C entry point and includes no
PyTorch header, so ``nvcc`` compiles it in seconds; the library is
loaded with ``ctypes`` and the Python wrappers pass raw device pointers
and PyTorch's current stream.  Nothing is built at import time: the first
``library(name)`` call compiles every kernel source that is not built yet,
one ``nvcc`` per source, all started together, into
``<repo>/build/torch_ext/``.  Library names carry a hash of the source and
flags, so an edited source is rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "torch_ext"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-lineinfo"]

# name -> (source relative to kernels/, extra nvcc flags)
SOURCES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "flash_fwd": ("flash_attention/csrc/flash_fwd.cu", ()),
    "flash_fwd_sm90": ("flash_attention/csrc/flash_fwd_sm90.cu", ("-ldl",)),
    "bucket_update": ("bucket_update/csrc/bucket_update.cu", ("--fmad=false",)),
    "quantize": ("quantize/csrc/quantize.cu", ("--fmad=false",)),
    "rglru_scan": ("rglru/csrc/rglru_scan.cu", ("--fmad=false",)),
    "rwkv6": ("rwkv6/csrc/rwkv6.cu", ("--fmad=false",)),
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc") or ""]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and PATH): the port's "
        "CUDA kernels are compiled from source on the machine with the card"
    )


def _target(name: str) -> Tuple[Path, List[str]]:
    src, extra = SOURCES[name]
    path = _PKG / src
    flags = _ARCH + _COMMON + list(extra)
    digest = hashlib.sha256(
        path.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so", [str(path)] + flags


def build_all() -> Dict[str, float]:
    """Compile every kernel library that is missing, all in parallel.
    Returns {name: seconds} for the libraries built by this call; each
    build's compiler output (register and spill counts) is kept beside
    the library as ``<lib>.log``."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = []
    for name in SOURCES:
        out, args = _target(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc] + args + ["-o", str(tmp)]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc, t0))
    times: Dict[str, float] = {}
    failed = []
    for name, out, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def build_log(name: str) -> str:
    """The compiler output of ``name``'s current build ('' if none)."""
    log = _target(name)[0].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building all missing ones
    first)."""
    lib = _LOADED.get(name)
    if lib is None:
        out, _ = _target(name)
        if not out.exists():
            build_all()
        lib = ctypes.CDLL(str(out))
        _LOADED[name] = lib
    return lib


_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


def c_params(text: str, fn: str) -> List[Tuple[object, str]]:
    """The parameters of ``extern "C" int fn(...)`` in a kernel source's
    text, as (ctypes type, name): a pointer is ``c_void_p``."""
    m = re.search(r'extern\s+"C"\s+int\s+' + fn + r"\s*\(([^)]*)\)", text)
    if m is None:
        raise KeyError(f"no extern \"C\" entry point {fn}")
    params = []
    for p in m.group(1).split(","):
        p = " ".join(p.replace("*", " * ").split())
        name = p.split()[-1]
        kind = p[: -len(name)].replace("const ", "").strip()
        params.append((ctypes.c_void_p if "*" in kind else _C_TYPES[kind],
                       name))
    return params


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (or -1: bad argument)."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with code {err}")
