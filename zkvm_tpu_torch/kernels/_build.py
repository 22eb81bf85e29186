"""Builds the CUDA kernels at first use and binds them with ctypes.

Each source (csrc/<source>.cu, which includes csrc/field25519.cuh and, for
the lane-parallel kernels, csrc/lanes.cuh) compiles with its own nvcc
process into a shared library with a plain C interface; build_all starts
them all together.  A kernel's source is csrc/<name>.cu unless SOURCES
names another: K11 and K12 are entries of K2's library.  Sources include no PyTorch header, so a build
takes seconds, not the minutes a torch.utils.cpp_extension build of the
same code takes.  Libraries land
in kernels/build/ (ignored by git), named by a hash of their sources and
flags, so an edited source is rebuilt and a built one is reused.

Every C entry point takes device pointers, sizes and the CUDA stream as
plain integers, launches on that stream without synchronising, and
returns cudaGetLastError(); the Python wrappers raise on a nonzero code.
An entry that takes a scratch buffer also takes its length in elements
and returns SCRATCH_TOO_SHORT, launching nothing, when the buffer is
shorter than its compile-time layout needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
SCRATCH_TOO_SHORT = -1
# C signature of each library's entry point (all return int)
SIGNATURES = {
    "decompress": ("zkvm_ristretto_decode", [_P, _P, _P, _L, _P]),
    "bucket_accumulate": ("zkvm_bucket_accumulate",
                          [_P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _P]),
    "bucket_fold": ("zkvm_bucket_fold", [_P, _P, _L, _P, _I, _I, _P]),
    "horner_check": ("zkvm_horner_check", [_P, _P, _P, _I, _I, _I, _P]),
    "seg_combine": ("zkvm_seg_combine", [_P, _P, _P, _P, _L, _P]),
    "point_add": ("zkvm_point_add", [_P, _P, _P, _L, _P]),
    "fe_mul": ("zkvm_fe_mul", [_P, _P, _P, _L, _P]),
    "fe_add": ("zkvm_fe_add", [_P, _P, _P, _L, _P]),
    "radix_sort": ("zkvm_radix_sort", [_P, _P, _P, _P, _L, _L, _I, _I, _I,
                                       _P]),
    "gather_words": ("zkvm_gather_words", [_P, _P, _P, _L, _I, _P]),
    "bucket_accumulate_words": ("zkvm_bucket_accumulate_words",
                                [_P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _P]),
    "bucket_accumulate_affine": ("zkvm_bucket_accumulate_affine",
                                 [_P, _P, _P, _P, _P, _L, _L, _I, _I, _I,
                                  _P]),
    "small_scan": ("zkvm_small_scan", [_P, _P, _P, _L, _I, _I, _I, _P]),
}

# kernels whose entry point lives in another kernel's source
SOURCES = {"bucket_accumulate_words": "bucket_accumulate",
           "bucket_accumulate_affine": "bucket_accumulate"}

_loaded: dict[str, ctypes._CFuncPtr] = {}


def source(name: str) -> str:
    """The source (csrc/<source>.cu, its library) of kernel `name`."""
    return SOURCES.get(name, name)


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def lib_path(name: str) -> Path:
    """The library built from kernel `name`'s source."""
    name = source(name)
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libzkvm_{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every missing library of the kernels `names` (default:
    all), one nvcc per source, all at once.  Returns {source: seconds} for
    those built; raises with the compiler's output when one fails.  The
    ptxas report (registers, spills) of each build is kept beside its
    library as <lib>.log."""
    names = dict.fromkeys(source(n) for n in (
        SIGNATURES if names is None else names))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    took = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def kernel(name: str):
    """The bound C entry point of library `name`, built if missing."""
    fn = _loaded.get(name)
    if fn is None:
        path = lib_path(name)
        if not path.exists():
            build_all([name])
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Call library `name`'s entry point on the current stream; tensors are
    passed as their data pointers.  Raises if the launch was refused."""
    stream = torch.cuda.current_stream().cuda_stream
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = kernel(name)(*conv, stream)
    if err == SCRATCH_TOO_SHORT:
        raise RuntimeError(f"CUDA kernel {name}: the scratch is shorter than "
                           "the kernel's layout needs; nothing launched")
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


def check_cuda(t: torch.Tensor, dtype: torch.dtype, shape: tuple, what: str):
    """Validate a tensor handed to a kernel: on a CUDA device, of `dtype`,
    contiguous, and of `shape` (None entries match any size)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if len(t.shape) != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{what}: expected shape {shape}, got {tuple(t.shape)}")
