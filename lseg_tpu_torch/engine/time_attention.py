"""Time the flat attention kernels B6 (forward) and B7 (backward) beside
SDPA and SDPA's backward at the flagship shape, (8, 901, 3072) bf16 with
16 heads of 64 (`--t` sets another token count), on one card.

    python lseg_tpu_torch/engine/time_attention.py [--root DIR] [--tag T]

It imports the port from `--root` (default: the checkout that holds this
file), so the same script times an older tree's kernels (one whose B7
takes no lse) in the same call as this one's: run them in turns (old,
new, new, old) and compare only within one call. Prints one JSON line:
the card's name and power limit, each time in ms (CUDA events over 20
calls after 3 warm-ups) and B7's device ms per call split by kernel
(torch.profiler over 5 calls). Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path


def kernel_split(torch, fn, calls=5):
    """Device ms per call of each CUDA kernel that `fn` launches, by
    kernel name, from torch.profiler (empty where it sees no device
    time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us:
            out[ev.key[:60]] = dev_us / 1e3 / calls
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root",
                    default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--t", type=int, default=901,
                    help="tokens per image (901: ViT-L/16 at 480x480)")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch

    from lseg_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 1
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

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, t, h, scale = 8, args.t, 16, 64 ** -0.5
    qkv = torch.randn(n, t, 3 * h * 64, device=dev, generator=g).to(
        torch.bfloat16)
    do = torch.randn(n, t, h * 64, device=dev, generator=g).to(torch.bfloat16)
    if "lse" in inspect.signature(fa.flash_attention_flat_bwd).parameters:
        out, lse = fa.flash_attention_flat(qkv, h, scale, return_lse=True)
        bwd = (lambda: fa.flash_attention_flat_bwd(qkv, out, do, lse, h,
                                                   scale))
    else:
        out = fa.flash_attention_flat(qkv, h, scale)
        bwd = lambda: fa.flash_attention_flat_bwd(qkv, out, do, h, scale)
    q, k, v = (qkv.view(n, t, 3, h, 64).permute(2, 0, 3, 1, 4).detach()
               .clone().requires_grad_())
    so = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                          scale=scale)
    dso = do.view(n, t, h, 64).transpose(1, 2)
    row = {"tag": args.tag, "card": card, "shape": [n, t, 3 * h * 64]}
    row["B6_ms"] = ms(lambda: fa.flash_attention_flat(qkv, h, scale))
    row["sdpa_ms"] = ms(lambda: torch.nn.functional.
                        scaled_dot_product_attention(q, k, v, scale=scale))
    row["B7_ms"] = ms(bwd)
    row["sdpa_bwd_ms"] = ms(lambda: torch.autograd.grad(
        so, (q, k, v), dso, retain_graph=True))
    row["kernels_ms"] = kernel_split(torch, bwd)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
