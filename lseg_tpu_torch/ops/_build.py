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

`compile_source` is the one compile step, with the one set of flags:
`load_kernels` runs it for every source at once, and `load_source` for
one source alone into a small library of its own (the toolchain probe,
`python -m lseg_tpu_torch.probe`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
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
    # x, t, tn (scratch), out, m, c, k, kp, x_bf16, out_bf16, scale, stream
    "lseg_fused_correlate": (_P,) * 4 + (_I,) * 6 + (ctypes.c_float, _P),
    # x, out, n, h, w, k, x_bf16, stream
    "lseg_upsample2x_argmax": (_P,) * 2 + (_I,) * 5 + (_P,),
    # x, sx, w, sc, b1, tn, out, m, c, e, k, x_bf16, stream
    "lseg_head1_correlate_argmax": (_P,) * 7 + (_I,) * 5 + (_P,),
    # xq, sx, wq, sw, bias, qkv (scratch), out, n, t, dim, valid_len,
    # scale, stream
    "lseg_flash_attention_qkv_fused": (_P,) * 7 + (_I,) * 4 + (
        ctypes.c_float, _P),
    # xq, w, sc, b1, tn, out, n, h, w, c, e, k, stream
    "lseg_head1_correlate_wup": (_P,) * 6 + (_I,) * 6 + (_P,),
    "lseg_head1_correlate_upsample_argmax": (_P,) * 6 + (_I,) * 6 + (_P,),
    # xq, sx, resid, w1, s1, b1, w2, s2, b2, pm, hq, sh (scratch), out,
    # m, dim, hidden, stream
    "lseg_mlp_fused": (_P,) * 13 + (_I,) * 3 + (_P,),
    # xq, sx, wq, sw, bias, wp, sp, bp, resid, qkv, aq, sa (scratch), out,
    # n, t, dim, valid_len, scale, stream
    "lseg_flash_attention_qkvp_fused": (_P,) * 13 + (_I,) * 4 + (
        ctypes.c_float, _P),
    # x, ln_g, ln_b, wq, sw, bias, xq, sx, qkv (scratch), out,
    # n, t, dim, valid_len, scale, eps, stream
    "lseg_flash_attention_ln_qkv_fused": (_P,) * 10 + (_I,) * 4 + (
        ctypes.c_float, ctypes.c_float, _P),
    # x, w1, d1, e1, s1_inv, w2, d2, e2, s2_inv, out, n, h, w, c, stream
    "lseg_fused_rcu": (_P,) * 10 + (_I,) * 4 + (_P,),
    # x, th, tw, wq, sc, bias, inv_in, inv_out, out, n, h, w, c, co,
    # out_int8, stream
    "lseg_fused_upsample_outconv": (_P,) * 9 + (_I,) * 6 + (_P,),
    # x, w, b, resid, out, m, k, n, x_bf16, resid_kind, out_bf16, stream
    "lseg_dense_residual": (_P,) * 5 + (_I,) * 6 + (_P,),
    # x, w_t, sw, out, m, k, stream
    "lseg_int8_sliced_scale": (_P,) * 4 + (_I,) * 2 + (_P,),
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


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Path of the library for the current sources and flags."""
    return BUILD_DIR / f"liblseg_kernels_{_digest(_sources())}.so"


def compile_source(src: Path, tag: str = ""):
    """Compile one `csrc` source alone, in its own `nvcc` process, with
    the flags of every build, into an object under `BUILD_DIR`.

    Returns (object, log): the log holds the command and what `nvcc` and
    `ptxas -v` printed; the object is None where `nvcc` failed. Raises
    `RuntimeError` where there is no `nvcc`."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = BUILD_DIR / f"{tag or src.stem}.{os.getpid()}.{src.stem}.o"
    cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}"
    if proc.returncode != 0:
        obj.unlink(missing_ok=True)
        return None, f"{log}nvcc failed ({proc.returncode})\n"
    return obj, log


def _link(objects, lib_path: Path):
    """Link `objects` into the shared library `lib_path` (atomically) and
    delete them; returns (linked, log)."""
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), "-shared", "-o", str(tmp), *map(str, objects)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objects:
        obj.unlink(missing_ok=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        return False, f"{log}nvcc link failed ({proc.returncode})\n"
    os.replace(tmp, lib_path)
    return True, log


def _bind(lib_path: Path) -> ctypes.CDLL:
    """Load a kernel library and set the argtypes of each entry point of
    `SIGNATURES` that it holds."""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    if hasattr(lib, "lseg_cuda_error_string"):
        lib.lseg_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lseg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _build(lib_path: Path, sources) -> None:
    """Compile `sources`, one `nvcc` process each, all at once, and link
    them into `lib_path` with the log beside it; raises `RuntimeError`
    with every failing source's log."""
    find_nvcc()
    tag = lib_path.stem
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(lambda src: compile_source(src, tag),
                              sources))
    log = [text for _, text in built]
    failed = [text for obj, text in built if obj is None]
    objects = [obj for obj, _ in built if obj is not None]
    if failed:
        for obj in objects:
            obj.unlink(missing_ok=True)
    else:
        linked, text = _link(objects, lib_path)
        log.append(text)
        if not linked:
            failed.append(text)
    lib_path.with_suffix(".log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """Compile (if the sources changed) and load the kernel library.

    Returns the `ctypes.CDLL` with argtypes set for every entry point;
    `load_kernels.build_seconds` and `load_kernels.build_log` tell what
    the build cost and what `ptxas -v` reported."""
    lib_path = library_path()
    t0 = time.perf_counter()
    if not lib_path.exists():
        _build(lib_path, sorted(CSRC.glob("*.cu")))
    load_kernels.build_seconds = time.perf_counter() - t0
    log_path = lib_path.with_suffix(".log")
    load_kernels.build_log = (log_path.read_text()
                              if log_path.exists() else "")
    return _bind(lib_path)


@functools.lru_cache(maxsize=None)
def load_source(name: str):
    """Compile one source of `csrc` (`name`, e.g. "int8_sliced_scale.cu")
    alone into a small library of its own, if it changed, and load it.

    Returns (library, log, seconds): what `nvcc` and `ptxas -v` printed
    and what the build cost. The library holds only that source's entry
    points (and `lseg_cuda_error_string` only where the source defines
    it)."""
    src = CSRC / name
    if not src.is_file() or src.suffix != ".cu":
        raise ValueError(f"no CUDA source {name!r} in {CSRC}")
    headers = sorted(CSRC.glob("*.cuh"))
    lib_path = BUILD_DIR / f"lib{src.stem}_{_digest([src, *headers])}.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        _build(lib_path, [src])
    log = lib_path.with_suffix(".log").read_text()
    return _bind(lib_path), log, time.perf_counter() - t0


def _kernel_name(mangled: str) -> str:
    """The `..._kernel` identifier (and template arguments) of a mangled
    entry point: the length-prefixed name whose prefix matches."""
    for m in re.finditer(r"(?=(\d{1,3})([a-z]\w*?_kernel)(I\w*?E)?)",
                         mangled):
        if int(m.group(1)) == len(m.group(2)):
            return m.group(2) + (m.group(3) or "")
    return mangled


def ptxas_summary(log: str):
    """One line per compiled kernel of a build log: registers, shared
    memory, spills."""
    name = None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            name = _kernel_name(hit.group(1))
        elif "spill stores" in line and name:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            yield (f"{name}: {regs} registers, "
                   f"{smem.group(1) if smem else 0} B static smem, "
                   f"{spill} B spilled")
            name = None


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


def check_operands(name: str, operands: dict) -> None:
    """{arg: (tensor, dtype)} of a kernel wrapper: TypeError for a wrong
    dtype on any device; on the card, ValueError unless each tensor is
    contiguous, 16-byte aligned and on the first one's device."""
    dev = next(iter(operands.values()))[0].device
    for arg, (v, dt) in operands.items():
        if v.dtype != dt:
            raise TypeError(f"{name}: {arg} must be {dt}, got {v.dtype}")
        if dev.type == "cuda" and (not v.is_contiguous() or v.data_ptr() % 16
                                   or v.device != dev):
            raise ValueError(f"{name}: {arg} must be contiguous, 16-byte "
                             f"aligned and on {dev}")


def check_launch(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = (lib.lseg_cuda_error_string(rc).decode()
               if hasattr(lib, "lseg_cuda_error_string") else "")
        raise RuntimeError(f"{name} launch failed: cudaError {rc} ({msg})")
