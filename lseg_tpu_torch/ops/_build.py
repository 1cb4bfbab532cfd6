"""Build and load the hand-written CUDA kernels of `lseg_tpu_torch/csrc`.

Every `*.cu` source compiles with `nvcc` for `sm_90a` to an object of
its own, all of them at once in parallel processes; the objects link into
ONE shared library with a plain C interface, which is loaded with
`ctypes`. No PyTorch headers are included, so a cold build takes seconds;
PyTorch's `torch.utils.cpp_extension` is not used (it needs `ninja` and
compiles the PyTorch headers for minutes). Device code shared between
kernels lives in `*.cuh` headers with internal linkage.

The library lands in `build/kernels/` at the root of the checkout, named
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing library. Where `nvcc` is missing the
build raises `RuntimeError`: there is no fallback to another path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argtypes; every launcher returns cudaGetLastError()
SIGNATURES = {
    # x, w, bias, out, n, h, w, c, patch, dim, stream
    "lseg_patch_embed": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # qkv, out, n, t, dim, valid_len, scale, stream
    "lseg_flash_attention_flat": (_P, _P, _I, _I, _I, _I, ctypes.c_float,
                                  _P),
    # x, ln_g, ln_b, q, s, rows, dim, eps, stream
    "lseg_ln_quantize_rows": (_P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _P),
    # x, ln_g, ln_b, wq, sw, bias, xq, sx, qkv (scratch), oq, os,
    # n, t, dim, valid_len, scale, eps, stream
    "lseg_flash_attention_ln_qkv_q8": (_P,) * 11 + (
        _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _P),
    # xq, w, sc, b1, tn, out, m, c, e, k, normalize, stream
    "lseg_head1_correlate": (_P,) * 6 + (_I,) * 5 + (_P,),
    # qkv, out, dout, dqkv, stats, n, t, dim, valid_len, scale, stream
    "lseg_flash_attention_flat_bwd": (_P,) * 5 + (_I,) * 4 + (
        ctypes.c_float, _P),
    # x, t, tnT (scratch), out, m, c, k, kp, x_bf16, scale, stream
    "lseg_fused_correlate": (_P,) * 4 + (_I,) * 5 + (ctypes.c_float, _P),
    # x, out, n, h, w, k, x_bf16, stream
    "lseg_upsample2x_argmax": (_P,) * 2 + (_I,) * 5 + (_P,),
    # x, sx, w, sc, b1, tn, out, m, c, e, k, x_bf16, stream
    "lseg_head1_correlate_argmax": (_P,) * 7 + (_I,) * 5 + (_P,),
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the lseg_tpu_torch CUDA kernels cannot be built on this host")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblseg_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """Compile (if the sources changed) and load the kernel library.

    Returns the `ctypes.CDLL` with argtypes set for every entry point;
    `load_kernels.build_seconds` and `load_kernels.build_log` tell what
    the build cost and what `ptxas -v` reported."""
    lib_path = library_path()
    log_path = lib_path.with_suffix(".log")
    t0 = time.perf_counter()
    if not lib_path.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{lib_path.stem}.{os.getpid()}"
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, _, proc in jobs:
            out = proc.communicate()[0]
            log.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(tmp),
                   *[str(obj) for _, obj, _ in jobs]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            if proc.returncode != 0:
                failed.append(f"nvcc link failed ({proc.returncode}):\n"
                              f"{proc.stdout}{proc.stderr}")
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        log_path.write_text("\n".join(log))
        if failed:
            raise RuntimeError("\n".join(failed))
        os.replace(tmp, lib_path)
    load_kernels.build_seconds = time.perf_counter() - t0
    load_kernels.build_log = (log_path.read_text()
                              if log_path.exists() else "")
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.lseg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lseg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_no_grad(name: str, *tensors) -> None:
    """Raise if a tensor that requires grad would reach a raw kernel
    launch, which has no autograd and would cut its gradient silently."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel launch has no "
            f"autograd; call it under torch.no_grad() or through its "
            f"autograd.Function")


def check_launch(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.lseg_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {rc} ({msg})")
