"""Time kernels B17 (`dense_residual`) and B10 (`fused_correlate`) in each
of their modes, the fp32 modes of B6 and B7, B16 (`mlp_fused`), the int8
attention kernels B2, B15, B8 and B9 with each of their stages, B18
(`fused_rcu`) at the fused decoder's four shapes and the int8 heads B13
(`head1_correlate_upsample_argmax`), B14 (`head1_correlate_wup_fused`)
and B5 (`head1_correlate_argmax_fused`) at the flagship head, B19
(`fused_upsample_outconv`), B3 (`ln_quantize_rows`), B4
(`head1_correlate_fused`), B11 (`upsample2x_argmax`), B1 (`patch_embed`)
and B20 (`int8_matmul_sliced_scale`), on one card, beside the PyTorch
call that computes the same function where there is one.

    python lseg_tpu_torch/engine/time_gemm.py [--root DIR] [--tag T]
        [--library]
        [--only B6_fp32,B16,B2,B15,B8,B9,B18,B13,B14,B5,B19,B3,B4,B11,B1,B20]

Shapes: B17 at ViT-L/16's fc2, (7208, 4096) . (4096, 1024) with a
residual, bf16 and fp32; B10 at the streamed head's (8, 240, 240, 512) bf16
pixels against K = 150, compute_dtype float32 and bfloat16; B6 and B7 on
fp32 qkv (8, 901, 3072) with 16 heads; B16 at ViT-L/16's MLP, (8, 901,
1024) codes with H = 4096, a real residual and `chip_smoke.py`'s outlier
hidden channels; B2 and B9 on a bf16 (8, 901, 1024) residual stream, B8
and B15 on its row codes, 16 heads, B15 with a real residual. For those
four, `<name>_stages` holds each stage's device time a call
(`torch.profiler` over 10 calls, the launches of a call named by their
kernels: `ln` the LN + quantize, `qkv_gemm` the int8 qkv product,
`interior` the attention, `projection` B15's output projection). B18
at (8, S, S, 256) for S = 120, 60, 30, 15 (2, 2, 2 and 1 launches a
request of the fused decoder): `B18_<S>_ms` each, `B18_request_ms` their
sum weighted by the launches, and `B18_<S>_stages` the device ms a call
by kernel name; B13, B14 and B5 at (8, 240, 240, 256) codes against K =
150 labels: `B13_ms`, `B14_ms`, `B5_ms` (bf16 path1 quantized in the
kernel) and `B5_int8_ms` (the codes), and each against K = 300 (two
label chunks): `B13_300_ms`, `B14_300_ms`, `B5_300_ms` (null where the
tree's wrapper refuses the shape), with `B13_stages`, `B14_stages` and
`B5_stages` the device ms a call by kernel name at K = 150. B19 at
refinenet2's (8, 60, 60, 256) -> bf16 and refinenet1's hand-off (8, 120,
120, 256) -> int8: `B19_r2_ms`, `B19_handoff_ms` and each one's
`_device_ms` (the kernel alone, `torch.profiler` over 50 calls) and
`_stages` (every kernel of a call, by name); B3 at
(8, 901, 1024): `B3_ms`, `B3_device_ms` and `B3_host_us`, the host time
of a wrapper call. B1 at the flagship (8, 480, 480, 3) -> (8, 900, 1024)
and at ViT-B/32's (8, 480, 480, 3) -> (8, 225, 768): `B1_ms`,
`B1_device_ms` (the kernel alone, `torch.profiler` over 20 calls),
`B1_host_us` (the host time of a wrapper call), the same for ViT-B/32
(`B1_b32_...`), and `B1_conv2d_ms`, the stride-16 bf16
`F.conv2d` on the same image and weight (its layout change not timed);
B20 at the reference probe's (2, 904, 1024) . (1024, 128): `B20_ms`
(a wrapper call, host-paced) and `B20_device_ms` (every kernel a call
launches, `torch.profiler` over 50 calls). It imports
the port from `--root`
(default: the checkout that holds this file), so the same script times an
older tree's kernels in the same call as this one's: run them in turns
(old, new, new, old) and compare only within one call. A mode an older
tree does not have (fp32 B6 and B7 before they were ported) reads null.
`--library` adds the PyTorch calls (`torch.addmm`, `torch.matmul`, SDPA in
fp32; B1's `F.conv2d` is always timed) and the names of the device kernels that one fp32 SDPA call and its
backward launch (`torch.profiler`), which say which of PyTorch's kernels
computes them. `--only` times the named rows alone (B17, B10, B6_fp32
(with B7_fp32), B16, B2, B15, B8, B9, B18, B13, B14, B5, B19, B3, B4,
B11, B1, B20). Prints
one JSON line: the card's name and power limit and
each time in ms (CUDA events over 20 calls after 3 warm-ups). Without a
card it exits 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def stage_of(kernel: str) -> str:
    """The stage of an int8 attention kernel's chain a device kernel is."""
    if "ln_quantize" in kernel:
        return "ln"
    if "qkv_int8_gemm" in kernel or "qkv_wgmma" in kernel:
        return "qkv_gemm"
    if "proj" in kernel:
        return "projection"
    return "interior"


def device_stages(fn, calls: int = 10) -> dict:
    """Device ms a call of `fn` by kernel name (`torch.profiler` over
    `calls` calls; memory copies and sets left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    stages = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "Memcpy" not in e.name and "Memset" not in e.name):
            stages[e.name] = stages.get(e.name, 0.0) + e.device_time_total
    return {k: v / calls / 1e3 for k, v in stages.items()}


# B18's shapes on the fused decoder (side, launches a request)
B18_SHAPES = ((120, 2), (60, 2), (30, 2), (15, 1))


def rcu_operands(dev, g, c: int = 256) -> list:
    """B18's operands after x, as `chip_smoke.py` makes them: two int8
    (C, 9C) kernels, each with the BatchNorm folded with its dequant
    scale and its inverse activation scale."""
    import torch

    from lseg_tpu_torch.ops.qconv import fold_bn_affine
    from lseg_tpu_torch.ops.quant import div127, inv127

    ops = []
    for a in (4.0, 16.0):
        wq = torch.randint(-127, 128, (c, 9 * c), device=dev, generator=g,
                           dtype=torch.int8)
        sw = 2e-3 * torch.rand(c, device=dev, generator=g) + 1e-4
        bn = (torch.rand(c, device=dev, generator=g) + 0.5,
              0.5 * torch.rand(c, device=dev, generator=g) + 0.1,
              0.1 * torch.randn(c, device=dev, generator=g),
              torch.rand(c, device=dev, generator=g) + 0.5)
        act = torch.tensor(a, device=dev)
        d, e = fold_bn_affine(div127(act), sw, *bn)
        ops += [wq, d, e, inv127(act)]
    return ops


def head_operands(dev, g, k):
    """The int8 heads' operands at the flagship, (8, 240, 240, 256) codes
    and bf16 path1 on their grid, E = 512, K labels: (codes, bf16 path1,
    sx, w1q, s1, b1, text)."""
    import torch

    n, h, w, c, e = 8, 240, 240, 256, 512
    x = (0.5 * torch.randn(n, h, w, c, device=dev, generator=g)).to(
        torch.bfloat16)
    sx = x.float().abs().amax() / 127.0
    xq = torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)
    w1q = torch.randint(-127, 128, (e, c), device=dev, generator=g,
                        dtype=torch.int8)
    s1 = 1e-3 * torch.rand(e, device=dev, generator=g) + 1e-4
    b1 = 0.1 * torch.randn(e, device=dev, generator=g)
    txt = torch.randn(k, e, device=dev, generator=g)
    return xq, x, sx, w1q, s1, b1, txt


def head_rows(row, only, dev, g, ms):
    """B13, B14 and B5 at the flagship head against K = 150 and 300: ms a
    call (None where the wrapper refuses the shape), and device ms a call
    by kernel name at K = 150."""
    from lseg_tpu_torch.ops import head1_correlate as hc

    def ms_or_none(fn):
        try:
            fn()
        except ValueError:
            return None
        return ms(fn)

    for k in (150, 300):
        xq, x, sx, w1q, s1, b1, txt = head_operands(dev, g, k)
        tag = "" if k == 150 else f"_{k}"
        calls = {
            "B13": lambda: hc.head1_correlate_upsample_argmax(
                xq, sx, w1q, s1, b1, txt, 1.0 / 0.07),
            "B14": lambda: hc.head1_correlate_wup_fused(
                xq, sx, w1q, s1, b1, txt, 1.0 / 0.07),
            "B5": lambda: hc.head1_correlate_argmax_fused(
                x, sx, w1q, s1, b1, txt),
            "B5_int8": lambda: hc.head1_correlate_argmax_fused(
                xq, sx, w1q, s1, b1, txt),
        }
        for name, fn in calls.items():
            if name.split("_")[0] not in only or (k == 300 and "int8" in
                                                  name):
                continue
            row[f"{name}{tag}_ms"] = ms_or_none(fn)
            if k == 150 and "int8" not in name:
                row[f"{name}_stages"] = device_stages(fn)
        del xq, x, txt


def decoder_head_rows(row, only, dev, g, ms):
    """B18 at the fused decoder's four (8, S, S, 256) shapes: ms a call
    and device ms a call by kernel name; the int8 heads (`head_rows`)."""
    import torch

    if "B18" in only:
        from lseg_tpu_torch.ops.qconv import fused_rcu

        c = 256
        ops = rcu_operands(dev, g, c)
        total = 0.0
        for side, launches in B18_SHAPES:
            x = torch.randn(8, side, side, c, device=dev,
                            generator=g).to(torch.bfloat16)
            fn = lambda: fused_rcu(x, *ops)  # noqa: E731
            row[f"B18_{side}_ms"] = ms(fn)
            row[f"B18_{side}_stages"] = device_stages(fn)
            total += launches * row[f"B18_{side}_ms"]
        row["B18_request_ms"] = total
    if only & {"B13", "B14", "B5"}:
        head_rows(row, only, dev, g, ms)


# B19's shapes: refinenet2 to bf16 (3h and 3i) and refinenet1's int8
# hand-off (3i)
B19_SHAPES = (("r2", (8, 60, 60, 256), False), ("handoff",
                                                 (8, 120, 120, 256), True))


def tail_rows(row, only, dev, g, ms):
    """B19 at its two shapes and B3 at ViT-L/16's (8, 901, 1024): ms a
    call (CUDA events over back-to-back wrapper calls), the device ms of
    the kernel alone (`torch.profiler` over 50 back-to-back calls), and
    for B3 the host microseconds of a wrapper call (200 calls enqueued
    without a synchronize)."""
    import time

    import torch

    def device_ms(fn, kernel, calls=50):
        """Device ms a call of the kernels whose names hold `kernel`."""
        return sum(v for k, v in device_stages(fn, calls).items()
                   if kernel in k)

    if "B19" in only:
        from lseg_tpu_torch.ops.decoder import fused_upsample_outconv

        c = 256
        wq = torch.randint(-127, 128, (c, c), device=dev, generator=g,
                           dtype=torch.int8)
        sw = 0.01 * torch.rand(c, device=dev, generator=g) + 1e-3
        b = 0.1 * torch.randn(c, device=dev, generator=g)
        for name, shape, int8 in B19_SHAPES:
            x = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
            s_in = x.float().abs().amax() / 127.0
            out_scale = torch.tensor(0.05, device=dev) if int8 else None
            fn = lambda: fused_upsample_outconv(  # noqa: E731
                x, wq, sw, b, s_in, out_scale)
            row[f"B19_{name}_ms"] = ms(fn)
            row[f"B19_{name}_device_ms"] = device_ms(fn, "outconv")
            row[f"B19_{name}_stages"] = device_stages(fn)
    if "B3" in only:
        from lseg_tpu_torch.ops.ln_quant import ln_quantize_rows

        d = 1024
        x = torch.randn(8, 901, d, device=dev, generator=g).to(
            torch.bfloat16)
        ln_g = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
        ln_b = 0.1 * torch.randn(d, device=dev, generator=g)
        fn = lambda: ln_quantize_rows(x, ln_g, ln_b)  # noqa: E731
        row["B3_ms"] = ms(fn)
        row["B3_device_ms"] = device_ms(fn, "ln_quantize")
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        row["B3_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()


def head_logit_rows(row, only, dev, g, ms):
    """B4 (`head1_correlate_fused`) at its two model shapes, the lowres
    head (8, 120, 120, 256) codes without the norm and the H/2 logits
    (8, 240, 240, 256) with it, each against K = 150 and 300; B11
    (`upsample2x_argmax`) at the streamed head's (8, 240, 240, 150) fp32
    logits and in bf16: ms a call (CUDA events) and the device ms of the
    kernel alone (`torch.profiler` over 20 calls)."""
    import torch

    def device_ms(fn, kernel, calls=20):
        """Device ms a call of the kernels whose names hold `kernel`."""
        return sum(v for k, v in device_stages(fn, calls).items()
                   if kernel in k)

    if "B4" in only:
        from lseg_tpu_torch.ops.head1_correlate import head1_correlate_fused

        e, c = 512, 256
        w1q = torch.randint(-127, 128, (e, c), device=dev, generator=g,
                            dtype=torch.int8)
        s1 = 1e-3 * torch.rand(e, device=dev, generator=g) + 1e-4
        b1 = 0.1 * torch.randn(e, device=dev, generator=g)
        sx = torch.tensor(0.02, device=dev)
        for name, side, normalize in (("lowres", 120, False),
                                      ("h2", 240, True)):
            xq = torch.randint(-127, 128, (8, side, side, c), device=dev,
                               generator=g, dtype=torch.int8)
            for k in (150, 300):
                txt = torch.randn(k, e, device=dev, generator=g)
                tag = f"B4_{name}" + ("" if k == 150 else f"_{k}")
                fn = lambda: head1_correlate_fused(  # noqa: E731
                    xq, sx, w1q, s1, b1, txt, 1.0 / 0.07, normalize)
                row[f"{tag}_ms"] = ms(fn)
                row[f"{tag}_device_ms"] = device_ms(fn, "head1_correlate")
            del xq
    if "B11" in only:
        from lseg_tpu_torch.ops.upsample_argmax import upsample2x_argmax

        x = torch.randn(8, 240, 240, 150, device=dev, generator=g)
        for name, lg in (("fp32", x), ("bf16", x.to(torch.bfloat16))):
            fn = lambda: upsample2x_argmax(lg)  # noqa: E731
            row[f"B11_{name}_ms"] = ms(fn)
            row[f"B11_{name}_device_ms"] = device_ms(fn, "upsample2x_argmax")


def embed_probe_rows(row, only, dev, g, ms):
    """B1 (`patch_embed`) at the flagship and at ViT-B/32's patch, with
    the stride-P bf16 convolution beside it; B20
    (`int8_matmul_sliced_scale`) at the reference probe's shape: ms a call
    (CUDA events), the device ms of every kernel a call launches
    (`torch.profiler`) and, for B1, the host us of a wrapper call."""
    import time

    import torch

    def device_ms(fn, calls):
        return sum(device_stages(fn, calls).values())

    if "B1" in only:
        from lseg_tpu_torch.ops.patch_embed import patch_embed

        x = torch.randn(8, 480, 480, 3, device=dev, generator=g)
        for tag, p, d in (("B1", 16, 1024), ("B1_b32", 32, 768)):
            w = (0.05 * torch.randn(p * p * 3, d, device=dev, generator=g)
                 ).to(torch.bfloat16)
            b = torch.randn(d, device=dev, generator=g)
            fn = lambda: patch_embed(x, w, b, p)  # noqa: E731
            row[f"{tag}_ms"] = ms(fn)
            row[f"{tag}_device_ms"] = device_ms(fn, 20)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            row[f"{tag}_host_us"] = (time.perf_counter() - t0) / 50 * 1e6
            torch.cuda.synchronize()
            if p == 16:
                xc = x.permute(0, 3, 1, 2).to(torch.bfloat16)
                wc = w.reshape(p, p, 3, d).permute(3, 2, 0, 1).contiguous()
                bc = b.to(torch.bfloat16)
                row["B1_conv2d_ms"] = ms(lambda: torch.nn.functional.conv2d(
                    xc, wc, bc, stride=p))
                del xc
    if "B20" in only:
        from lseg_tpu_torch import probe
        from lseg_tpu_torch.ops.scaled_int8 import int8_matmul_sliced_scale

        args = probe.b20_inputs("sliced", dev, g)
        fn = lambda: int8_matmul_sliced_scale(*args)  # noqa: E731
        row["B20_ms"] = ms(fn)
        row["B20_device_ms"] = device_ms(fn, 50)
        row["B20_stages"] = device_stages(fn, 50)


def int8_attention_rows(row, only, dev, g, ms):
    """B2, B15, B8 and B9 at (8, 901, 1024), 16 heads: ms a call, and
    each stage's device ms a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lseg_tpu_torch.ops import flash_attention as fa
    from lseg_tpu_torch.ops.quant import quantize_rows

    n, t, d, heads, scale = 8, 901, 1024, 16, 64 ** -0.5
    x = torch.randn(n, t, d, device=dev, generator=g).to(torch.bfloat16)
    ln_g = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
    ln_b = 0.1 * torch.randn(d, device=dev, generator=g)
    xq, sx = quantize_rows(x)

    def codes(*shape):
        return torch.randint(-127, 128, shape, device=dev, generator=g,
                             dtype=torch.int8)

    wq, wp = codes(3 * d, d), codes(d, d)
    sw = 1e-3 * torch.rand(3 * d, device=dev, generator=g)
    bias = 0.05 * torch.randn(3 * d, device=dev, generator=g)
    sp = 2e-2 / d ** 0.5 * torch.rand(d, device=dev, generator=g)
    bp = 0.05 * torch.randn(d, device=dev, generator=g)
    res = (2.0 * torch.randn(n, t, d, device=dev, generator=g)).to(
        torch.bfloat16)
    calls = {
        "B2": lambda: fa.flash_attention_ln_qkv_fused_q8(
            x, ln_g, ln_b, wq, sw, bias, heads, scale),
        "B15": lambda: fa.flash_attention_qkvp_fused(
            xq, sx, wq, sw, bias, wp, sp, bp, res, heads, scale),
        "B8": lambda: fa.flash_attention_qkv_fused(xq, sx, wq, sw, bias,
                                                   heads, scale),
        "B9": lambda: fa.flash_attention_ln_qkv_fused(
            x, ln_g, ln_b, wq, sw, bias, heads, scale),
    }
    for name, fn in calls.items():
        if name not in only:
            continue
        row[f"{name}_ms"] = ms(fn)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        stages = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and "Memcpy" not in e.name and "Memset" not in e.name):
                key = stage_of(e.name)
                stages[key] = stages.get(key, 0.0) + e.device_time_total
        row[f"{name}_stages"] = {k: v / 10 / 1e3 for k, v in stages.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root",
                    default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--library", action="store_true",
                    help="also time the PyTorch call of each function")
    ap.add_argument("--only", default="B17,B10,B6_fp32,B16",
                    help="comma-separated rows to time")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    sys.path.insert(0, args.root)
    import torch

    from lseg_tpu_torch.ops import dense, flash_attention as fa
    from lseg_tpu_torch.ops import fused_correlate as fc

    if not torch.cuda.is_available():
        print("time_gemm: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]

    def ms(fn, warmup=3, iters=20):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def kernels(fn):
        """Names of the device kernels one call of `fn` launches."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sorted({e.key for e in prof.key_averages()
                       if e.device_time_total > 0})

    def mode_ms(fn):
        """ms of `fn`, or None where this tree's wrapper refuses the mode."""
        try:
            fn()
        except TypeError:
            return None
        return ms(fn)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    row = {"tag": args.tag, "card": card}
    bf, f32 = torch.bfloat16, torch.float32
    t = 901  # tokens of ViT-L/16 at 480x480

    if "B17" in only:
        m, k, n = 7208, 4096, 1024
        for name, dt in (("B17_bf16", bf), ("B17_fp32", f32)):
            x = torch.randn(m, k, device=dev, generator=g).to(dt)
            w = (torch.randn(k, n, device=dev, generator=g) / k ** 0.5).to(dt)
            b = torch.randn(n, device=dev, generator=g)
            r = torch.randn(m, n, device=dev, generator=g).to(dt)
            row[f"{name}_ms"] = ms(lambda: dense.dense_residual(
                x, w, b, r, out_dtype=dt))
            if args.library:
                c = (r.float() + b).to(dt)
                row[f"{name}_addmm_ms"] = ms(lambda: torch.addmm(c, x, w))
            del x, w, r

    if "B10" in only:
        emb = torch.randn(8, 240, 240, 512, device=dev, generator=g).to(bf)
        txt = torch.randn(150, 512, device=dev, generator=g)
        for name, dt in (("B10_fp32", f32), ("B10_bf16", bf)):
            row[f"{name}_ms"] = ms(lambda: fc.fused_correlate(
                emb, txt, compute_dtype=dt))
            if args.library:
                xn = torch.nn.functional.normalize(
                    emb.float().reshape(-1, 512), dim=-1).to(dt)
                tn = torch.nn.functional.normalize(txt, dim=-1).t().contiguous(
                    ).to(dt)
                row[f"{name}_matmul_ms"] = ms(lambda: torch.matmul(xn, tn))
                del xn
        del emb

    if "B6_fp32" in only:
        h, scale = 16, 64 ** -0.5
        qkv = torch.randn(8, t, 3 * h * 64, device=dev, generator=g)
        do = torch.randn(8, t, h * 64, device=dev, generator=g)
        row["B6_fp32_ms"] = mode_ms(lambda: fa.flash_attention_flat(qkv, h,
                                                                     scale))
        if row["B6_fp32_ms"] is not None:
            out, lse = fa.flash_attention_flat(qkv, h, scale, return_lse=True)
            row["B7_fp32_ms"] = ms(lambda: fa.flash_attention_flat_bwd(
                qkv, out, do, lse, h, scale))
        else:
            row["B7_fp32_ms"] = None
        if args.library:
            q, kk, v = (qkv.view(8, t, 3, h, 64).permute(2, 0, 3, 1, 4)
                        .detach().clone().requires_grad_())
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row["sdpa_fp32_ms"] = ms(lambda: sdpa(q, kk, v, scale=scale))
            row["sdpa_fp32_kernels"] = kernels(lambda: sdpa(q, kk, v,
                                                            scale=scale))
            so = sdpa(q, kk, v, scale=scale)
            dso = do.view(8, t, h, 64).transpose(1, 2)

            def sdpa_bwd():
                return torch.autograd.grad(so, (q, kk, v), dso,
                                           retain_graph=True)

            row["sdpa_bwd_fp32_ms"] = ms(sdpa_bwd)
            row["sdpa_bwd_fp32_kernels"] = kernels(sdpa_bwd)
    if "B16" in only:
        from lseg_tpu_torch.ops.mlp import mlp_fused
        from lseg_tpu_torch.ops.quant import quantize_rows

        d, hid = 1024, 4096
        xq, sx = quantize_rows(torch.randn(8, t, d, device=dev, generator=g))
        w1 = torch.randint(-127, 128, (hid, d), device=dev, generator=g,
                           dtype=torch.int8)
        w2 = torch.randint(-127, 128, (d, hid), device=dev, generator=g,
                           dtype=torch.int8)
        s1 = 2e-3 / d ** 0.5 * torch.rand(hid, device=dev, generator=g)
        b1 = 0.5 * torch.randn(hid, device=dev, generator=g)
        b1[hid // 16::hid // 8] += torch.arange(1.0, 9.0, device=dev)
        s2 = 2e-2 / hid ** 0.5 * torch.rand(d, device=dev, generator=g)
        b2 = 0.05 * torch.randn(d, device=dev, generator=g)
        res = (2.0 * torch.randn(8, t, d, device=dev, generator=g)).to(bf)
        row["B16_ms"] = ms(lambda: mlp_fused(xq, sx, res, w1, s1, b1, w2, s2,
                                             b2))
    if only & {"B2", "B15", "B8", "B9"}:
        int8_attention_rows(row, only, dev, g, ms)
    if only & {"B18", "B13", "B14", "B5"}:
        decoder_head_rows(row, only, dev, g, ms)
    if only & {"B19", "B3"}:
        tail_rows(row, only, dev, g, ms)
    if only & {"B4", "B11"}:
        head_logit_rows(row, only, dev, g, ms)
    if only & {"B1", "B20"}:
        embed_probe_rows(row, only, dev, g, ms)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
