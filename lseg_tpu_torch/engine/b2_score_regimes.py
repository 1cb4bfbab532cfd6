"""Kernel B2 against its plain twin across widths, token counts and two
weight-scale regimes, on the card.

    python3 -m lseg_tpu_torch.engine.b2_score_regimes

For each (D, heads, T, weight scale) it prints, over three seeds, the
relative error of B2's dequantized outputs against the plain twin's (the
quantity `chip_smoke.py` gates at LNQKV_REL = 2e-2) and the share of query
rows whose plain softmax puts more than 0.99 on one key. Weight scales of
~1e-3 (phase 2's) give scores of a few units, as a model's; ~1e-2 gives
scores in the hundreds, where nearly every row is one-hot and a code that
B3's LayerNorm stage may round one level apart at a bin edge (its own
gate) moves a near-tied row's output by several percent, at every width.
Exits 1 without a card.
"""

from __future__ import annotations

import sys

import torch

from lseg_tpu_torch.ops.flash_attention import (
    _qkv_plain,
    flash_attention_ln_qkv_fused_q8,
    flash_attention_ln_qkv_fused_q8_plain,
)
from lseg_tpu_torch.ops.ln_quant import ln_quantize_rows_plain

CASES = ((768, 12, 226, 1e-2), (1024, 16, 226, 1e-2),
         (768, 12, 901, 1e-2), (1024, 16, 901, 1e-2),
         (768, 12, 226, 1e-3), (1024, 16, 901, 1e-3))


def one(dev, d, heads, t, weight_scale, seed):
    """(relative error, share of one-hot rows) of one seeded batch of 8."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(8, t, d, device=dev, generator=g).to(torch.bfloat16)
    gam = 1 + 0.1 * torch.randn(d, device=dev, generator=g)
    bet = 0.1 * torch.randn(d, device=dev, generator=g)
    wq = torch.randint(-127, 128, (3 * d, d), device=dev, generator=g,
                       dtype=torch.int8)
    sw = weight_scale * torch.rand(3 * d, device=dev, generator=g)
    bias = 0.05 * torch.randn(3 * d, device=dev, generator=g)
    args = (x, gam, bet, wq, sw, bias, heads, 64 ** -0.5)
    oq, os_ = flash_attention_ln_qkv_fused_q8(*args)
    pq, ps = flash_attention_ln_qkv_fused_q8_plain(*args)
    ref = pq.float() * ps
    err = float((oq.float() * os_ - ref).abs().max() / ref.abs().max())
    xq, sx = ln_quantize_rows_plain(x, gam, bet)
    q, k, _ = _qkv_plain(xq, sx, wq, sw, bias).float().reshape(
        8, t, 3, heads, 64).unbind(2)
    p = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q, k) * 64 ** -0.5,
                      -1)
    return err, float((p.amax(-1) > 0.99).float().mean())


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    for d, heads, t, ws in CASES:
        runs = [one(dev, d, heads, t, ws, seed) for seed in range(3)]
        print(f"D={d} heads={heads} T={t} weight scale ~{ws:g}: rel err "
              f"{[round(e, 5) for e, _ in runs]}, one-hot rows "
              f"{[round(s, 4) for _, s in runs]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
