"""Kernel and toolchain probe of the port, on the card.

    python -m lseg_tpu_torch.probe <case>
    python -m lseg_tpu_torch.probe --sources [NAME ...]

The counterpart of the reference's `scripts/mosaic_probe.py` and, for
kernel B9, of `scripts/kernel_census.py`. It is the path that launches the
three kernels that no model path of the reference runs, each against its
plain PyTorch twin on seeded inputs at a full-width shape:

- `sliced`, `rows`, `rows1d`, `bcast` (kernel B20, the reference probe's
  int8 product times three summed 128-wide scale slices): compile
  `csrc/int8_sliced_scale.cu` alone, in its own `nvcc` process, into a
  small library of its own, print its `ptxas -v` summary, then launch the
  kernel from that library once, with the variant's scale block shape, at
  the reference's x (2, 904, 1024) and w (1024, 128), bit for bit;
- `dense` (kernel B17, `dense_residual`) at ViT-L/16's fc2,
  (7208, 4096) . (4096, 1024) bf16 with a bf16 residual;
- `ln_qkv` (kernel B9, `flash_attention_ln_qkv_fused`) at the flagship
  (8, 901, 1024) with 16 heads.

Each case prints `<case>: OK` when the kernel agrees with its twin, and
exits 0. `--sources` compiles each `csrc/*.cu` (or each NAME given, with
or without `.cu`) alone and prints its `ptxas` lines and the seconds it
took; the exit code is the number of sources that failed, as the
census's is. Needs a CUDA device: without one it exits 1 naming it, and
never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from lseg_tpu_torch.ops._build import (
    CSRC,
    compile_source,
    load_source,
    ptxas_summary,
)
from lseg_tpu_torch.ops.dense import dense_residual, dense_residual_plain
from lseg_tpu_torch.ops.flash_attention import (
    flash_attention_ln_qkv_fused,
    flash_attention_ln_qkv_fused_plain,
)
from lseg_tpu_torch.ops.scaled_int8 import (
    SCALE_SHAPES,
    int8_matmul_sliced_scale,
    int8_matmul_sliced_scale_plain,
)

SEED = 0
B20_SOURCE = "int8_sliced_scale.cu"
CASES = (*SCALE_SHAPES, "dense", "ln_qkv")
# case -> the launch counter's name of the kernel it runs
KERNELS = {**{v: "int8_matmul_sliced_scale" for v in SCALE_SHAPES},
           "dense": "dense_residual",
           "ln_qkv": "flash_attention_ln_qkv_fused"}
# B20: bit for bit (compared by value: the plain sum's leading 0 may turn
# a -0.0 into +0.0). The int32 sums are exact, and each product and sum is
# an `_rn` operation in the twin's order.
B20_RTOL, B20_ATOL = 0.0, 0.0
# B17 with bf16 x: the same bf16 operands, 4096 fp32 products summed in
# another order, so an output may round one bf16 ulp apart (at most 2^-7
# of |plain|), plus an absolute floor for sums that cancel to near zero.
DENSE_RTOL, DENSE_ATOL = 2.0 ** -7, 1e-3
# B17 with fp32 x: full fp32 products on both sides (TF32 off), summed in
# another order: a few fp32 ulps, as for B10's fp32 mode.
DENSE_FP32_RTOL, DENSE_FP32_ATOL = 1e-5, 1e-4
# B9: within 2e-2 of max|plain|, the bound of the reference's own variant
# check: the LN codes and the online softmax may each round a step apart.
LN_QKV_REL = 2e-2


def compare(name, got, ref, rtol, atol):
    """(max |got - ref|, count outside atol + rtol |ref|), printed; a shape,
    dtype or non-finite output counts every element as outside."""
    torch.cuda.synchronize()
    if (got.shape != ref.shape or got.dtype != ref.dtype
            or not torch.isfinite(got.float()).all()):
        print(f"  {name}: {tuple(got.shape)} {got.dtype} vs "
              f"{tuple(ref.shape)} {ref.dtype}, finite "
              f"{bool(torch.isfinite(got.float()).all())}")
        return float("inf"), ref.numel()
    d = (got.float() - ref.float()).abs()
    bad = int((d > atol + rtol * ref.float().abs()).sum())
    err = float(d.max())
    print(f"  {name}: max_abs={err:.6g} over_tol={bad} (rtol={rtol:g}, "
          f"atol={atol:g})", flush=True)
    return err, bad


def b20_inputs(variant, dev, g, n=2, t=904, d=1024):
    """Seeded int8 codes over the full range and 384 scales of both signs
    in the variant's block shape."""
    x = torch.randint(-128, 128, (n, t, d), device=dev, generator=g,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (d, 128), device=dev, generator=g,
                      dtype=torch.int8)
    sw = 1e-3 * (torch.rand(SCALE_SHAPES[variant], device=dev, generator=g)
                 - 0.25)
    return x, w, sw


def dense_inputs(dev, g, m=7208, k=4096, n=1024, dtype=torch.bfloat16,
                 residual=torch.bfloat16):
    """x, w (scaled so outputs stay O(1)), b and a residual (or None)."""
    x = torch.randn(m, k, device=dev, generator=g).to(dtype)
    w = (torch.randn(k, n, device=dev, generator=g) * k ** -0.5).to(dtype)
    b = 0.1 * torch.randn(n, device=dev, generator=g)
    r = (None if residual is None else
         torch.randn(m, n, device=dev, generator=g).to(residual))
    return x, w, b, r


def ln_qkv_inputs(dev, g, n=8, t=901, d=1024):
    """B9's operands: a bf16 residual stream, LN params, int8 (3D, D) qkv
    weight, its scales and bias."""
    x = torch.randn(n, t, d, device=dev, generator=g).to(torch.bfloat16)
    ln_g = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
    ln_b = 0.1 * torch.randn(d, device=dev, generator=g)
    wq = torch.randint(-127, 128, (3 * d, d), device=dev, generator=g,
                       dtype=torch.int8)
    sw = 1e-3 * torch.rand(3 * d, device=dev, generator=g)
    bias = 0.05 * torch.randn(3 * d, device=dev, generator=g)
    return x, ln_g, ln_b, wq, sw, bias


def run_case(case: str, dev) -> dict:
    """Run one case on `dev` (a CUDA device): the kernel once against its
    plain twin. Returns {"kernel", "max_abs_err", "ok"}."""
    if case not in CASES:
        raise ValueError(f"unknown probe case {case!r}; one of {CASES}")
    g = torch.Generator(device=dev).manual_seed(SEED)
    print(f"{case}: kernel {KERNELS[case]}", flush=True)
    if case in SCALE_SHAPES:
        lib, log, seconds = load_source(B20_SOURCE)
        print(f"  {B20_SOURCE} built alone in {seconds:.2f} s")
        for line in ptxas_summary(log):
            print(f"  ptxas: {line}")
        args = b20_inputs(case, dev, g)
        err, bad = compare(
            f"int8_matmul_sliced_scale (2,904,1024) scales "
            f"{SCALE_SHAPES[case]}", int8_matmul_sliced_scale(*args, lib=lib),
            int8_matmul_sliced_scale_plain(*args), B20_RTOL, B20_ATOL)
    elif case == "dense":
        args = dense_inputs(dev, g)
        err, bad = compare("dense_residual (7208,4096).(4096,1024) + bf16 "
                           "residual", dense_residual(*args),
                           dense_residual_plain(*args), DENSE_RTOL,
                           DENSE_ATOL)
    else:
        args = (*ln_qkv_inputs(dev, g), 16, 64 ** -0.5)
        ref = flash_attention_ln_qkv_fused_plain(*args)
        err, bad = compare("flash_attention_ln_qkv_fused (8,901,1024) 16 "
                           "heads", flash_attention_ln_qkv_fused(*args), ref,
                           0.0, LN_QKV_REL * float(ref.float().abs().max()))
    print(f"{case}: OK" if bad == 0 else f"{case}: FAIL ({bad} outputs "
          f"outside tolerance)", flush=True)
    return {"kernel": KERNELS[case], "max_abs_err": err, "ok": bad == 0}


def probe_sources(names=None) -> int:
    """Compile each source of `csrc` (or each of `names`) alone and print
    its `ptxas` lines and seconds; returns the number that failed."""
    if names:
        srcs = [CSRC / (n if n.endswith(".cu") else f"{n}.cu")
                for n in names]
    else:
        srcs = sorted(CSRC.glob("*.cu"))
    failed = 0
    for src in srcs:
        if not src.is_file():
            print(f"{src.name}: FAIL (no such source in {CSRC})")
            failed += 1
            continue
        t0 = time.perf_counter()
        obj, log = compile_source(src, tag="probe")
        seconds = time.perf_counter() - t0
        print(f"{src.name}: {'OK' if obj else 'FAIL'} in {seconds:.2f} s",
              flush=True)
        for line in ptxas_summary(log):
            print(f"  ptxas: {line}")
        if obj is None:
            print(log[-4000:])
            failed += 1
        else:
            obj.unlink()
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lseg_tpu_torch.probe",
        description="Launch one kernel without a model path against its "
                    "plain twin, or compile each CUDA source alone.")
    ap.add_argument("case", nargs="?", choices=CASES,
                    help="the kernel case to run")
    ap.add_argument("--sources", nargs="*", metavar="NAME",
                    help="compile these csrc sources alone (all without "
                         "names)")
    args = ap.parse_args(argv)
    if (args.case is None) == (args.sources is None):
        ap.error("give one case, or --sources")
    if not torch.cuda.is_available():
        print("probe: no CUDA device (torch.cuda.is_available() is False); "
              "the probe runs on the card only", file=sys.stderr)
        return 1
    if args.sources is not None:
        return probe_sources(args.sources)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return 0 if run_case(args.case, torch.device("cuda", 0))["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
