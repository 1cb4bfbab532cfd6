"""Where kernel B6's time goes: its source rebuilt with one part cut out
at a time, each variant timed beside the full kernel at the flagship
shape, (8, 901, 3072) bf16 with 16 heads of 64, on one card.

    python -m lseg_tpu_torch.engine.ablate_attention [--t T]

Each variant is `csrc/flash_attention_flat.cu` with its headers, one or
more text substitutions applied to `flash_flat.cuh`, compiled with the
flags of every build (`ops._build.NVCC_FLAGS`) into a library of its own
under `build/kernels/ablate/` and loaded with ctypes. A cut variant's
output is wrong by design; only its time is read. A substitution that no
longer matches the source fails the run. Prints one JSON line: the card's
name and power limit and each variant's ms (CUDA events over 20 calls
after 3 warm-ups, the variants timed in turn, twice). Without a card or
`nvcc` it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys

# variant -> [(regex, replacement)] on flash_flat.cuh
CUTS = {
    "full": [],
    # the products and their feeding alone: no mask, max, exp, sums or
    # rescale
    "no_softmax": [(r"const int k0 = j \* BKV;\n.*?(?=uint32_t pa\[4\]\[4\];)",
                    "")],
    # every exponential replaced by its argument
    "no_exp": [(re.escape("exp2_approx("), "(")],
    # no P.V product
    "no_pv": [(r"wg::product_pb\(o, pa, wg::desc\(sm\.v\[s\]\)\);\s*"
               r"wg::wait<0>\(\);", "")],
    # the library's exp2f (with its subnormal rescale) for the bare
    # ex2.approx.ftz instruction
    "exp2f": [(re.escape("exp2_approx("), "exp2f(")],
}


def build(name, subs, nvcc, flags, csrc, out_dir):
    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    for f in ("lseg_common.cuh", "wgmma.cuh", "flash_attention_flat.cu"):
        shutil.copy(csrc / f, d / f)
    text = (csrc / "flash_flat.cuh").read_text()
    for pat, rep in subs:
        text, n = re.subn(pat, rep, text, flags=re.S)
        if n == 0:
            raise RuntimeError(f"ablate {name}: {pat!r} matches nothing")
    (d / "flash_flat.cuh").write_text(text)
    lib = d / f"lib{name}.so"
    cmd = [nvcc, *flags, "-shared", "-o", str(lib),
           str(d / "flash_attention_flat.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"ablate {name}: nvcc failed\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=901)
    args = ap.parse_args(argv)
    import torch

    from lseg_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("ablate_attention: no CUDA device", file=sys.stderr)
        return 1
    nvcc = _build.find_nvcc()
    out_dir = _build.BUILD_DIR / "ablate"
    libs = {}
    for name, subs in CUTS.items():
        fn = build(name, subs, nvcc, _build.NVCC_FLAGS, _build.CSRC,
                   out_dir).lseg_flash_attention_flat
        fn.argtypes = list(_build.SIGNATURES["lseg_flash_attention_flat"])
        fn.restype = ctypes.c_int
        libs[name] = fn
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, t, d = 8, args.t, 1024
    qkv = torch.randn(n, t, 3 * d, device=dev, generator=g).to(
        torch.bfloat16)
    out = torch.empty(n, t, d, dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def ms(fn, warmup=3, iters=20):
        call = (lambda: fn(qkv.data_ptr(), out.data_ptr(), None, n, t, d, t,
                           64 ** -0.5, stream))
        for _ in range(warmup):
            if call() != 0:
                raise RuntimeError("ablate: launch failed")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    times = {name: [] for name in libs}
    for _ in range(2):
        for name, fn in libs.items():
            times[name].append(ms(fn))
    print(json.dumps({"card": card, "shape": [n, t, 3 * d], "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
