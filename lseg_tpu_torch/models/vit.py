"""Dense ViT image encoder with explicit multi-level taps (torch port of
`lseg_tpu/models/vit.py`).

Blocks run as a Python loop over per-block modules; the encoder returns
the block outputs at the 4 hook depths (cls token first) and the patch
grid. Blocks after the last hook are not instantiated, as in the
reference. Unlike the reference's flashflat path, the token sequence is
not padded to a multiple of 8 (a TPU sublane concern), so attention runs
over exactly the 1 + gh*gw real tokens.

Attention `impl`:
- 'flashflat' (fast config, head_dim 64, even heads): the fused qkv
  projection's flat (N, T, 3D) output goes straight into the
  hand-written flash kernel (`ops.flash_attention`), which emits the flat
  (N, T, D) input of the output projection;
- anything else: einsum attention with fp32 softmax (the reference's
  'xla' path), scores in `scores_dtype`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lseg_tpu_torch import ViTConfig, flat_flash_eligible
from lseg_tpu_torch.models.layers import Dense, LayerNorm, lecun_normal_
from lseg_tpu_torch.ops.flash_attention import flash_attention_flat
from lseg_tpu_torch.ops.patch_embed import patch_embed, patch_embed_plain
from lseg_tpu_torch.ops.resize import resize_bilinear


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class Attention(nn.Module):
    """timm ViT self-attention: fused qkv with bias, scale hd**-0.5."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 impl: str = "xla", scores_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.impl = impl
        self.scores_dtype = scores_dtype
        self.qkv = Dense(dim, 3 * dim, dtype, device)
        self.proj = Dense(dim, dim, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, d = x.shape
        h = self.num_heads
        hd = d // h
        scale = hd ** -0.5
        qkv = self.qkv(x)
        if self.impl == "flashflat" and flat_flash_eligible(d, h, False):
            return self.proj(flash_attention_flat(qkv, h, scale))
        q, k, v = qkv.reshape(n, t, 3, h, hd).unbind(2)
        s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float())
        s = s.to(self.scores_dtype) * scale
        attn = torch.softmax(s.float(), dim=-1).to(self.dtype)
        out = torch.einsum("nhqk,nkhd->nqhd", attn.float(), v.float())
        return self.proj(out.to(self.dtype).reshape(n, t, d))


class Mlp(nn.Module):
    """fc1 -> GELU ('exact' erf or 'tanh') -> fc2."""

    def __init__(self, dim: int, hidden: int, dtype=torch.float32,
                 gelu: str = "exact", device=None):
        super().__init__()
        self.approximate = "tanh" if gelu == "tanh" else "none"
        self.fc1 = Dense(dim, hidden, dtype, device)
        self.fc2 = Dense(hidden, dim, dtype, device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class Block(nn.Module):
    """Pre-norm transformer block: x += attn(ln1(x)); x += mlp(ln2(x)),
    LayerNorm eps 1e-6."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = LayerNorm(d, 1e-6, dtype, device)
        self.attn = Attention(d, cfg.num_heads, dtype, cfg.attn_impl,
                              _dtype(cfg.attn_scores_dtype), device)
        self.norm2 = LayerNorm(d, 1e-6, dtype, device)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio), dtype, cfg.mlp_gelu,
                       device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """Stride-p patch embedding as one (p*p*C, D) matmul.

    `fused` with a bf16 model runs the hand-written kernel (B1); else the
    matmul form, with the same rounding points in the model dtype. The
    weight is stored flattened to (p*p*C, D), rows ordered (row, col,
    channel); the bias stays fp32 (it is added to the fp32 sum)."""

    def __init__(self, dim: int, patch: int, in_ch: int = 3,
                 dtype=torch.float32, fused: bool = False, device=None):
        super().__init__()
        self.patch = patch
        self.dtype = dtype
        self.fused = fused
        self.weight = nn.Parameter(torch.empty(
            (patch * patch * in_ch, dim), dtype=dtype, device=device),
            requires_grad=False)
        self.bias = nn.Parameter(torch.empty(
            (dim,), dtype=torch.float32, device=device),
            requires_grad=False)

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight.shape[0], generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and self.dtype == torch.bfloat16:
            return patch_embed(x.float().contiguous(), self.weight,
                               self.bias, self.patch)
        return patch_embed_plain(x, self.weight, self.bias, self.patch,
                                 self.dtype)


class DenseViT(nn.Module):
    """(N, H, W, 3) -> 4 tapped (N, 1 + gh*gw, D) sequences and (gh, gw)."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None):
        super().__init__()
        if cfg.tp_layout:
            raise NotImplementedError("tp_layout is a JAX sharding layout")
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.embed_dim
        g0 = cfg.pretrain_grid
        self.patch_embed = PatchEmbed(d, cfg.patch_size, 3, dtype,
                                      cfg.patch_fused, device)
        self.cls_token = nn.Parameter(torch.empty(
            (1, 1, d), dtype=torch.float32, device=device),
            requires_grad=False)
        self.pos_embed = nn.Parameter(torch.empty(
            (1, 1 + g0 * g0, d), dtype=torch.float32, device=device),
            requires_grad=False)
        self.blocks = nn.ModuleList(
            Block(cfg, dtype, device) for _ in range(cfg.hooks[-1] + 1))

    def reset_parameters(self, generator=None):
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor):
        cfg = self.cfg
        n, h, w, _ = x.shape
        p = cfg.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} is not a multiple of {p}")
        gh, gw = h // p, w // p
        d = cfg.embed_dim
        x = self.patch_embed(x)
        cls = self.cls_token.to(self.dtype).expand(n, 1, d)
        x = torch.cat([cls, x], dim=1)

        # position embedding resized from the pretraining grid
        # (align_corners=False, torch's default)
        g0 = cfg.pretrain_grid
        pos_tok, pos_grid = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gh, gw) != (g0, g0):
            pos_grid = resize_bilinear(pos_grid.reshape(1, g0, g0, d), gh,
                                       gw, align_corners=False)
            pos_grid = pos_grid.reshape(1, gh * gw, d)
        x = x + torch.cat([pos_tok, pos_grid], dim=1).to(self.dtype)

        taps = []
        hooks = set(cfg.hooks)
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in hooks:
                taps.append(x)
        return taps, (gh, gw)
