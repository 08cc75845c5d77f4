"""Build the CUDA sources under ``repro_torch/csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <name>.cu

into ``csrc/_build/`` (listed in ``.gitignore``), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  ``build_all`` starts one ``nvcc`` per missing source, all
at once.  A failed build raises :class:`KernelBuildError` with nvcc's
output.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
KERNELS = ("binary_matmul", "binary_conv", "binary_dwconv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}     # nvcc/ptxas output of this process's builds


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found on PATH or under CUDA_HOME/bin")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=KERNELS) -> dict[str, Path]:
    """Compile every source in ``names`` whose library is missing, one nvcc
    per source, all started together; returns ``{name: library path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    jobs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        jobs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode == 0:
            os.replace(tmp, paths[name])   # atomic: concurrent builders agree
        else:
            os.unlink(tmp)
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{out}")
    if failed:
        raise KernelBuildError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed; its
    ``<name>_launch`` entry point gets ``argtypes`` from the caller."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def launch(name: str, argtypes: list, *args, entry: str | None = None) -> None:
    """Call ``<name>_launch(*args)`` (or ``entry``) from ``csrc/<name>.cu`` and
    raise on the ``cudaError_t`` it returns (a refused launch never runs, and
    a later ``torch.cuda.synchronize()`` would not report it)."""
    lib = load(name)
    fn = getattr(lib, entry or f"{name}_launch")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    rc = fn(*args)
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed: cudaError_t {rc} "
                           f"({lib.error_string(rc).decode()})")


def require(t, name: str, dtype, shape: tuple, device=None) -> None:
    """Check what a kernel takes: a contiguous CUDA tensor of ``dtype`` (or
    of one of a tuple of dtypes) and ``shape`` (``None`` entries are free),
    on ``device`` when given."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
            want is not None and got != want for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
