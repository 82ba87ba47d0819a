"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` into
``_build/<name>-<source hash>.so``, a shared library with a plain C
interface that :mod:`ctypes` loads. The hash of the source names the
output, so a library is rebuilt exactly when its source changes. The
sources compile all at once, one ``nvcc`` each. A missing ``nvcc`` or a
failed build raises; nothing falls back.

Every C entry takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()``; :func:`check` raises on a nonzero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry, by source: name -> (argtypes, restype).
SIGNATURES = {
    "clause_eval": {
        "clause_counts_replicated": ((_P,) * 4 + (_I,) * 4 + (_P,), _I),
        "clause_counts_batch_replicated": ((_P,) * 4 + (_I,) * 5 + (_P,),
                                           _I),
        "clause_counts_batch_packed_replicated": ((_P,) * 3 + (_I,) * 5
                                                  + (_P,), _I),
        "clause_counts_batch_pruned_replicated": ((_P,) * 5 + (_I,) * 8
                                                  + (_P,), _I),
        "clause_counts_batch_pruned_packed_replicated": (
            (_P,) * 4 + (_I,) * 8 + (_P,), _I),
    },
    "feedback": {
        "feedback_plane_i8": ((_P,) * 7 + (_F, _F, _I, _I, _I, _P), _I),
        "feedback_plane_i16": ((_P,) * 7 + (_F, _F, _I, _I, _I, _P), _I),
        "feedback_plane_replicated_i8": ((_P,) * 9 + (_I,) * 5 + (_P,), _I),
        "feedback_plane_replicated_i16": ((_P,) * 9 + (_I,) * 5 + (_P,), _I),
    },
    "probe": {
        "b1_mma_probe": ((_P,) + (_I,) * 3 + (_P,) * 3, _I),
        "popc_probe": ((_P,) + (_I,) * 3 + (_P,) * 3, _I),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from source at first use"
    )


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Returns name -> .so."""
    names = tuple(SIGNATURES) if names is None else tuple(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    exe = nvcc()
    procs = []
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}.cu (exit {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed),
    with every entry's argtypes and restype set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
