"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles at first use, with ``nvcc`` alone, into a shared
library with a plain C interface, loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds.  Libraries land in ``kernels/build/`` (git-ignored)
under a name that carries a digest of the source and the flags, so an edited
source never loads a stale library.  ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them.

Flags: ``sm_90a`` (Hopper), ``-O3``, and no ``--use_fast_math``: the int8
codec's divisions and roundings must equal the plain version's bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry returned a CUDA error code."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put it on PATH)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, started) -> None:
    if started is None:
        return
    out, tmp, proc = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, out)      # atomic: a concurrent builder never sees half


def build_all(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, all at once."""
    names = list(names)
    with _lock:
        started = [(n, _start(n)) for n in names]
        errors = []
        for n, st in started:
            try:
                _finish(n, st)
            except KernelBuildError as e:
                errors.append(str(e))
        if errors:
            raise KernelBuildError("\n".join(errors))


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``signatures`` ({C function: argtypes}, each returning an int CUDA
    error code) declared on it."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                for fn, argtypes in signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _libs[name] = lib
    return lib


def require_hopper(t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on an sm_90 card (the kernels' only target)."""
    if t.device.type != "cuda":
        raise ValueError(f"kernel input must be a CUDA tensor, got {t.device}")
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"kernels are built for sm_90a only; {t.device} is sm_{cap[0]}"
            f"{cap[1]}")


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a C entry."""
    if rc != 0:
        raise KernelLaunchError(f"{what}: CUDA error {rc}")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
