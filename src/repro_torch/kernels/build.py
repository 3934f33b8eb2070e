"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` file exposes a plain C entry point and includes no
PyTorch header, so ``nvcc`` compiles it in seconds; the library is
loaded with ``ctypes`` and the Python wrappers pass raw device pointers
and PyTorch's current stream.  Nothing is built at import time: the first
``library(name)`` call compiles every kernel source that is not built yet,
one ``nvcc`` per source, all started together, into
``<repo>/build/torch_ext/``.  Library names carry a hash of the source and
flags, so an edited source is rebuilt and a stale library is never loaded.
Loading and building hold one module lock, so a background thread (a
staged swap loading what its layout needs) and the training loop never
build the same library at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
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
# held around every build and load: _compile's temporary names are
# per process, so two threads must not build at once
_LOCK = threading.RLock()


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


def _flags(name: str) -> List[str]:
    return _ARCH + _COMMON + list(SOURCES[name][1])


def _target(name: str) -> Tuple[Path, List[str]]:
    path = _PKG / SOURCES[name][0]
    flags = _flags(name)
    digest = hashlib.sha256(
        path.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so", [str(path)] + flags


def _compile(jobs: Dict[str, Tuple[Path, List[str]]]) -> Dict[str, Tuple[str, float]]:
    """Run one nvcc per job, all started together: {key: (library path,
    its source and flags)} -> {key: (compiler output, seconds)}.  A library
    is written under a temporary name and moved into place only once it
    built; each compiler output is kept beside it as ``<lib>.log``.  Raises
    if any build failed."""
    import time

    with _LOCK:
        nvcc = nvcc_path() if jobs else ""
        procs = []
        for key, (out, args) in jobs.items():
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            procs.append((key, out, tmp, time.perf_counter(), subprocess.Popen(
                [nvcc] + args + ["-o", str(tmp)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        done: Dict[str, Tuple[str, float]] = {}
        failed = []
        for key, out, tmp, t0, proc in procs:
            log, _ = proc.communicate()
            done[key] = (log, time.perf_counter() - t0)
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{key}:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return done


def build_all() -> Dict[str, float]:
    """Compile every kernel library that is missing, all in parallel.
    Returns {name: seconds} for the libraries built by this call; each
    build's compiler output (register and spill counts) is kept beside
    the library as ``<lib>.log``."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {name: _target(name) for name in SOURCES}
        jobs = {name: job for name, job in jobs.items()
                if not job[0].exists()}
        return {name: s for name, (_, s) in _compile(jobs).items()}


def build_sources(texts: Dict[str, str], lib: str,
                  out_dir: Path) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """Build revisions of kernel library ``lib``'s source with the flags
    ``library(lib)`` is built with: {name: source text} -> {name: (loaded
    library, compiler output)}, one nvcc each, all started together, into
    ``out_dir/<name>.cu`` and ``out_dir/lib<name>.so``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in texts.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        jobs[name] = (out_dir / f"lib{name}.so", [str(cu)] + _flags(lib))
    done = _compile(jobs)
    return {name: (ctypes.CDLL(str(jobs[name][0])), done[name][0])
            for name in texts}


def _short_name(mangled: str) -> str:
    """``kernel<D>`` of a mangled entry function name: the last of its
    length-prefixed names, and its first template argument if it is an
    int (``_ZN12_GLOBAL__N_121flash_fwd_tf32_kernelILi256EEEv...`` ->
    ``flash_fwd_tf32_kernel<256>``)."""
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while True:
        m = re.match(r"\d+", mangled[i:])
        if m is None:
            break
        j = i + m.end()
        name, i = mangled[j:j + int(m.group())], j + int(m.group())
    t = re.match(r"ILi(\d+)E", mangled[i:])
    return name + (f"<{t.group(1)}>" if t else "")


def ptxas_report(log: str, kernel: str = "") -> List[str]:
    """The register, spill, advisory (C75xx) and warning lines of an nvcc
    log (its ``-Xptxas -v`` output), each as ``kernel<D>: line``, where
    ``kernel<D>`` is the entry function's name and first template argument.
    Only the kernels whose short name starts with ``kernel`` when it is
    given."""
    lines, current = [], "?"
    for line in log.splitlines():
        m = re.search(r"function '(\w+)'", line)
        if "Compiling entry function" in line:
            current = _short_name(m.group(1)) if m else "?"
            continue
        # an advisory (C75xx) or warning names its function itself
        advisory = "warning" in line.lower() or "(C75" in line
        where = _short_name(m.group(1)) if advisory and m else current
        if not where.startswith(kernel):
            continue
        if "Used" in line or "spill stores" in line:
            lines.append(f"{where}: {line.split(':', 1)[-1].strip()}")
        elif advisory:
            text = re.sub(r" in (the )?function '\w+'", "", line.strip())
            lines.append(f"{where}: {text[:200]}")
    return lines


def build_log(name: str) -> str:
    """The compiler output of ``name``'s current build ('' if none)."""
    log = _target(name)[0].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building all missing ones
    first)."""
    lib = _LOADED.get(name)       # a loaded library never waits on a build
    if lib is not None:
        return lib
    with _LOCK:
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
