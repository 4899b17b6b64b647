"""Build and load the port's hand-written CUDA kernels.

Every ``kernels/<name>/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes).  Each source
compiles in its own ``nvcc`` process, all started together, and one link
step joins them.  Headers (``*.cuh`` anywhere under ``kernels/``) are
found through one ``-I`` per directory that holds them.  The library
lands in ``build/repro_torch/`` at the root of the checkout, named by a
hash of the sources and headers: it is built at first use and again
whenever either changes.

A missing ``nvcc`` or a failed build raises; the ops never fall back to
their plain versions for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_KERNELS = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[pathlib.Path]:
    return sorted(_KERNELS.glob("*/csrc/*.cu"))


def headers() -> list[pathlib.Path]:
    return sorted(_KERNELS.glob("**/*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _digest(srcs) -> str:
    """Hash of the given sources, every header and the flags."""
    h = hashlib.sha256()
    for p in [*srcs, *headers()]:
        h.update(str(p.relative_to(_KERNELS)).encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{out}")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))


def build() -> pathlib.Path:
    """Compile the kernels if the library for the current sources does not
    exist yet; return its path."""
    srcs = sources()
    digest = _digest(srcs)
    lib = BUILD_DIR / f"librepro_torch_{digest}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    objdir = BUILD_DIR / f"obj_{digest}_{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    objs = [objdir / f"{p.parent.parent.name}_{p.stem}.o" for p in srcs]
    incs = [f"-I{d}" for d in sorted({str(h.parent) for h in headers()})]
    _run_all([[nvcc, *ARCH_FLAGS, *NVCC_FLAGS, *incs, "-c", str(s), "-o",
               str(o)] for s, o in zip(srcs, objs)])
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs),
               "-o", str(tmp)]])
    os.replace(tmp, lib)          # atomic: a reader never sees half a file
    shutil.rmtree(objdir, ignore_errors=True)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ragged_decode_launch.argtypes = [
        I,                 # dtype code (see dtype_code)
        P, P, P, P, P,     # q, k, v, pos, out
        P, P,              # lse (null: not written), scratch
        I, I, I, I, I,     # B, Smax, Hkv, rep, hd
        I, I,              # n_split, L (ops.split_geometry)
        F,                 # scale
        P]                 # stream
    lib.ragged_decode_launch.restype = I
    lib.flash_attention_launch.argtypes = [
        I,                 # dtype code
        P, P, P, P,        # q, k, v, out
        P,                 # lse (float32 (B, Hq, Sq)) or null
        I, I, I, I, I, I,  # B, Hq, Hkv, Sq, Skv, hd
        ctypes.POINTER(ctypes.c_longlong),   # 12 strides (see ops)
        I, F,              # causal, scale
        P]                 # stream
    lib.flash_attention_launch.restype = I
    lib.flash_attention_bwd_launch.argtypes = [
        I,                 # dtype code
        P, P, P, P, P,     # q, k, v, o, dO
        P, P,              # lse, D scratch (float32 (B, Hq, Sq))
        P, P, P,           # dq, dk, dv
        I, I, I, I, I, I,  # B, Hq, Hkv, Sq, Skv, hd
        ctypes.POINTER(ctypes.c_longlong),   # 24 strides (see ops)
        I, F,              # causal, scale
        P]                 # stream
    lib.flash_attention_bwd_launch.restype = I
    lib.ragged_prefill_launch.argtypes = [
        I,                 # dtype code
        P, P, P, P, P, P,  # q, k, v, start, qlen, out
        I, I, I, I, I, I,  # B, T, Smax, Hkv, rep, hd
        F,                 # scale
        P]                 # stream
    lib.ragged_prefill_launch.restype = I
    L = ctypes.c_longlong
    lib.matmul_launch.argtypes = [
        I, I,              # dtype, out dtype codes
        P, P, P,           # x, y, out
        I, I, I,           # M, N, K
        L, L, L,           # row strides of x, y, out
        P]                 # stream
    lib.matmul_launch.restype = I
    lib.stream_copy_launch.argtypes = [P, P, L, P]   # src, dst, nbytes, stream
    lib.stream_copy_launch.restype = I
    lib.stream_scale_add_launch.argtypes = [
        I,                 # dtype code
        P, P, P,           # x, y, out
        L, F, F,           # n, a, b
        P]                 # stream
    lib.stream_scale_add_launch.restype = I
    lib.bitonic_sort_launch.argtypes = [
        I,                 # 0 float32, 1 int32
        P, P, P,           # src, work (or null), out
        I, L,              # rows, n
        L, L, L,           # row strides of src, work, out
        I, I,              # lb, C (ops.sort_plan)
        P]                 # stream
    lib.bitonic_sort_launch.restype = I
    lib.bitonic_sort_kernel_launches.argtypes = []
    lib.bitonic_sort_kernel_launches.restype = L
    lib.cuda_error_string.argtypes = [I]
    lib.cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def dtype_code(dtype) -> int:
    """The C side's element-type code: 0 float32, 1 bfloat16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"not {dtype}")
    return codes[dtype]


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        msg = library().cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
