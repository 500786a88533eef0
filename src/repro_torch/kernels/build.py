"""Build the hand-written CUDA kernels at first use and bind them.

Each ``csrc/<name>.cu`` (with the shared headers ``csrc/*.cuh``) compiles
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Builds go into
``csrc/_build/`` (git-ignored), named by a digest of the source, every
header and the compiler flags, so a stale library is never loaded;
several sources build concurrently, one ``nvcc`` each.  Only the
repository's own sources are compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCES = ("sr_matmul", "decode_fused", "outer_accum", "sr_round",
           "wkv6", "wkv6_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.access(path, os.X_OK):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names=SOURCES) -> dict:
    """Compile every library in `names` that is missing, concurrently.

    Returns {name: seconds spent building it (0.0 if it was present)}.
    Raises RuntimeError with the compiler's output if a build fails.
    The compiler's resource report (-Xptxas -v) is kept beside each
    library as ``<name>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: lib_path(n) for n in names if not lib_path(n).exists()}
    secs = {n: 0.0 for n in names}
    procs = {}
    t0 = time.monotonic()
    for n, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[n] = time.monotonic() - t0
        (BUILD_DIR / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {n} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The bound library for csrc/<name>.cu, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer for a ctypes call."""
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device` as a ctypes pointer (the
    raw handle straight from torch's C API where it has one: a Stream
    object costs microseconds on a path that is bound by host time)."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return ctypes.c_void_p(raw(device.index))
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class LaunchCounter:
    """Count of kernel launches made by one wrapper (a plain int)."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0

    def reset(self) -> None:
        self.n = 0
