"""Build the native sources under ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes plain C functions and is compiled on its
own with ``nvcc``, at first use, into
``build/paddle_tpu_torch/lib<name>-<hash>.so`` beside the package
(``<hash>`` covers the source and the flags, so an edited source builds
anew), then loaded with :mod:`ctypes`. The source includes no PyTorch
header, which keeps a build to seconds.

The host route (:func:`load_host`) does the same for a host C++ source,
``csrc/<name>.cc`` (the parameter server's tables, the inference C
API), with the host compiler (``c++``, else ``g++``: ``-O2 -shared
-fPIC -std=c++17 -pthread``, the JAX package's flags for the same
source) and the library's own flags (``HOST_EXTRA_FLAGS``: CPython's
headers and library for the C API, which embeds the interpreter), which
the library's path hashes too. The launcher
starts servers and trainers together, so the build runs under a lock
file beside the library: one process compiles, the others wait and load
its result.

Nothing here falls back: a missing compiler or a failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "HOST_FLAGS",
           "HOST_EXTRA_FLAGS", "find_nvcc",
           "find_host_compiler", "library_path", "host_library_path",
           "build", "load", "load_host"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
HOST_FLAGS = ("-shared", "-fPIC", "-std=c++17", "-pthread", "-O2")

_loaded: Dict[str, ctypes.CDLL] = {}

# nvcc processes this process started: the serving fleet's compile
# contract reads it (a scaled-up engine or a restarted process builds
# nothing the warm phase or the parent already built)
nvcc_runs = 0


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else ``$CUDA_HOME/bin/nvcc``
    (``/usr/local/cuda`` by default). Raises ``RuntimeError`` if absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file() and os.access(cand, os.X_OK):
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        f"in {CSRC} cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by source and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are
    not built yet, one ``nvcc`` per source, all started together.
    Returns the wall seconds each build took (0.0 when already built);
    the compiler's output goes to ``<library>.log``. Raises
    ``RuntimeError`` naming the source on a failed compile."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = {n: library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    secs = {n: 0.0 for n in names}
    if not todo:
        return secs
    global nvcc_runs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
        nvcc_runs += 1
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


# ------------------------------------------------------------ host route
def find_host_compiler() -> str:
    """The host C++ compiler: ``c++`` on ``PATH``, else ``g++``. Raises
    ``RuntimeError`` if neither is there."""
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no host C++ compiler (c++ or g++) on PATH: the host sources in "
        f"{CSRC} cannot be built")


def _python_embed_flags() -> list:
    """Compile and link flags of a library that embeds CPython, from the
    running interpreter: its headers, and its shared library where there
    is one (loaded into a Python process, the library also resolves the
    interpreter's symbols from the process)."""
    import sysconfig

    flags = [f"-I{sysconfig.get_paths()['include']}"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    version = (sysconfig.get_config_var("LDVERSION")
               or sysconfig.get_config_var("VERSION"))
    if libdir and (Path(libdir) / f"libpython{version}.so").exists():
        flags += [f"-L{libdir}", f"-Wl,-rpath,{libdir}",
                  f"-lpython{version}"]
    return flags


# the flags of one host library beyond HOST_FLAGS
HOST_EXTRA_FLAGS = {"pd_inference_c": _python_embed_flags}


def _extra_flags(name: str) -> list:
    extra = HOST_EXTRA_FLAGS.get(name)
    return extra() if extra else []


def host_library_path(name: str) -> Path:
    """Where ``csrc/<name>.cc`` builds to, keyed by source and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cc").read_bytes())
    h.update(" ".join([*HOST_FLAGS, *_extra_flags(name)]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<name>.cc``, built
    first if needed under the build's lock file (module docstring).
    Raises ``RuntimeError`` with the compiler's output on a failed
    compile."""
    key = f"host:{name}"
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    import fcntl

    out = host_library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_host_compiler(), *HOST_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cc"), *_extra_flags(name)]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            out.with_suffix(".log").write_text(proc.stdout)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"host build of {name}.cc failed (exit "
                    f"{proc.returncode}):\n{proc.stdout[-4000:]}")
            os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _loaded[key] = lib
    return lib
