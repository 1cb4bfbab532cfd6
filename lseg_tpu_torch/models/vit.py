"""Dense ViT image encoder with explicit multi-level taps (torch port of
`lseg_tpu/models/vit.py`).

Blocks run as a Python loop over per-block modules; the encoder returns
the block outputs at the 4 hook depths (cls token first) and the patch
grid. Blocks after the last hook are not instantiated, as in the
reference. Unlike the reference's flashflat path, the token sequence is
not padded to a multiple of 8 (a TPU sublane concern), so attention runs
over exactly the 1 + gh*gw real tokens.

Attention `impl`:
- 'flashlnq' with `quant_int8='static'` (the int8 fast config, head_dim
  64, even heads): LayerNorm 1, the int8 qkv projection, attention and the
  per-row int8 quantize of its output run in kernel B2
  (`ops.flash_attention.flash_attention_ln_qkv_fused_q8`), whose codes
  feed the int8 output projection directly; `attn_variant='i8qk'` takes
  B2's int8 Q.K^T mode (`qk_int8=True`). The reference's other variants
  (lean, lx2, st, leanst, quad, octo, mono) reorder or refold the same
  arithmetic on the TPU, and the port runs them all as B2's default mode;
- 'flashq' with `quant_int8='static'` (bench.py's `fast_flashq` rung): the
  LayerNorm-1 output is row-quantized (`ops.quant.quantize_rows`), and the
  int8 qkv projection of those codes and attention run in kernel B8
  (`ops.flash_attention.flash_attention_qkv_fused`), whose bf16 output
  goes through the int8 output projection (`StaticQuantDense`);
- 'flashqp' with `quant_int8='static'` (the fused block): the LayerNorm-1
  output is row-quantized, and the int8 qkv projection, attention, the
  per-(row, head pair) requantize, the int8 output projection, its bias
  and the residual run in kernel B15
  (`ops.flash_attention.flash_attention_qkvp_fused`), which returns the
  block's residual stream after attention;
- 'flashflat' (or 'flashlnq' / 'flashq' / 'flashqp' unquantized): the
  fused qkv projection's
  flat (N, T, 3D) output goes straight into the flash kernel B6, which
  emits the flat (N, T, D) input of the output projection; where grad is
  enabled it goes through `flash_attention_flat_fn`, whose backward is
  kernel B7 and writes dqkv in the same flat layout;
- anything else: einsum attention with fp32 softmax (the reference's
  'xla' path), scores in `scores_dtype`.

With `quant_int8='static'` the projections are `StaticQuantDense`; with
`True` / 'dynamic' they are `QuantDense` (fp32 weights quantized at every
call), except attention's under 'flash', whose reference branch builds
float heads-major projections and never quantizes. With
`mlp_fused` and tanh GELU the LayerNorm-2 output is row-quantized and the
whole MLP with its residual runs in kernel B16 (`ops.mlp.mlp_fused`);
otherwise, with `ln_quant_fused`, the MLP takes LayerNorm 2 + the row
quantize from kernel B3 (`ops.ln_quant.ln_quantize_rows`), and
`mlp_act_cal` adds the calibrated per-tensor scale of the GELU output (the
block's `act_scale`). The reference takes that B3 branch only where its
padded T is a multiple of 8, which holds wherever its flash path pads; the
port takes it under the same condition, computed from the reference's
padded T. The reference declares `act_scale` inside that branch, so a
tree made at a T that skips it has no such leaf: the port's block drops
the parameter when a loaded state_dict lacks it, and calibration drops it
where the calibration forward skipped the branch (running the branch
without it then raises).

`tp_layout=True` is the reference's head-major parameter layout for
tensor parallelism ((D, 3, H, hd) qkv, (H, hd, D) proj); its branch runs
einsum attention in `scores_dtype`, no flat kernel and no token padding.
The port keeps the flat parameters (`utils.convert` reshapes the
head-major leaves) and runs the same einsum path. Cut over a model group
(`parallel.tensor.shard_module_`), each Attention and Mlp of a float
block runs this rank's heads and hidden units, in either layout.

`plain=True` swaps every kernel for its plain PyTorch twin (the
comparison path of `chip_smoke.py`); nothing picks it automatically.

`remat=True` runs each block under `torch.utils.checkpoint` where grad
is enabled (the reference's `nn.remat(Block)`): the backward recomputes
the block's activations, so the attention forward runs twice per step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lseg_tpu_torch import ViTConfig, flat_flash_eligible
from lseg_tpu_torch.models.layers import Dense, LayerNorm, lecun_normal_
from lseg_tpu_torch.ops.flash_attention import (
    flash_attention_flat,
    flash_attention_flat_fn,
    flash_attention_flat_plain,
    flash_attention_ln_qkv_fused_q8,
    flash_attention_ln_qkv_fused_q8_plain,
    flash_attention_qkv_fused,
    flash_attention_qkv_fused_plain,
    flash_attention_qkvp_fused,
    flash_attention_qkvp_fused_plain,
)
from lseg_tpu_torch.ops.ln_quant import (
    ln_quantize_rows,
    ln_quantize_rows_plain,
)
from lseg_tpu_torch.ops.mlp import mlp_fused, mlp_fused_plain
from lseg_tpu_torch.ops.patch_embed import patch_embed, patch_embed_plain
from lseg_tpu_torch.ops.quant import (
    EPS,
    QuantDense,
    StaticQuantDense,
    div127,
    int8_matmul_preact,
    int8_matmul_prequant,
    int8_matmul_prequant_act,
    quantize_rows,
    record_amax,
)
from lseg_tpu_torch.ops.resize import resize_bilinear
from lseg_tpu_torch.parallel.tensor import copy_to_model, row_parallel

# attention impls whose reference path pads T to a multiple of 8
_PADDING_IMPLS = ("flashflat", "flashq", "flashlnq")
# attention impls that run the flat kernels B6 and B7 on float weights
_FLAT_IMPLS = _PADDING_IMPLS + ("flashqp",)


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def dense(in_features: int, out_features: int, dtype, quant,
          device=None) -> nn.Module:
    """`Dense`, `StaticQuantDense` for `quant='static'`, or `QuantDense`
    for `True` / 'dynamic' (the reference's `_dense`)."""
    if quant == "static":
        return StaticQuantDense(in_features, out_features, dtype,
                                device=device)
    if quant in (True, "dynamic"):
        return QuantDense(in_features, out_features, dtype, device=device)
    return Dense(in_features, out_features, dtype, device)


class Attention(nn.Module):
    """timm ViT self-attention: fused qkv with bias, scale hd**-0.5.

    Cut over a model group (`parallel.tensor.shard_module_`), it holds
    `num_heads` = H / n of the heads, takes its input through
    `copy_to_model` and sums its output projection over the group."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 impl: str = "xla", scores_dtype=torch.float32,
                 quant=False, plain: bool = False, device=None,
                 variant: str = "v1", tp_layout: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.group = None
        self.impl = impl
        self.tp_layout = tp_layout
        # B2's int8 Q.K^T mode (the reference passes qk_int8 on flashlnq)
        self.qk_int8 = variant == "i8qk"
        self.dtype = dtype
        self.scores_dtype = scores_dtype
        self.plain = plain
        flat_ok = flat_flash_eligible(dim, num_heads, tp_layout)
        # LN1 inside kernel B2 (the reference's flashlnq branch)
        self.ln_fused = impl == "flashlnq" and flat_ok and quant == "static"
        # int8 qkv of row-quantized inputs inside kernel B8 (flashq)
        self.qkv_fused = impl == "flashq" and flat_ok and quant == "static"
        # the whole half-block with its residual inside kernel B15
        self.qkvp_fused = (impl == "flashqp" and flat_ok
                           and quant == "static")
        self.flat = (impl in _FLAT_IMPLS and flat_ok and not self.qkv_fused
                     and not self.qkvp_fused)
        if impl == "flash" and quant in (True, "dynamic"):
            quant = False  # the reference's 'flash' never quantizes
        self.qkv = dense(dim, 3 * dim, dtype, quant, device)
        self.proj = dense(dim, dim, dtype, quant, device)

    def shard(self, group, n: int) -> None:
        """Run this rank's H / n heads of a cut model group: the flat
        kernels where `flat_flash_eligible(D / n, H / n, tp_layout)`
        holds, einsum attention otherwise."""
        self.group = group
        self.num_heads //= n
        self.flat = self.impl in _FLAT_IMPLS and flat_flash_eligible(
            self.num_heads * self.head_dim, self.num_heads, self.tp_layout)

    def forward_qkvp(self, x: torch.Tensor,
                     resid: torch.Tensor) -> torch.Tensor:
        """resid + attn(x) for the `qkvp_fused` path: `x` is the LayerNorm-1
        output, row-quantized here; B15 adds the projection's bias and the
        residual stream `resid` itself."""
        op = (flash_attention_qkvp_fused_plain if self.plain
              else flash_attention_qkvp_fused)
        xq, sx = quantize_rows(x)
        qkv, p = self.qkv, self.proj
        out = op(xq, sx, qkv.weight_q, qkv.scale, qkv.bias, p.weight_q,
                 p.scale, p.bias, resid.to(torch.bfloat16).contiguous(),
                 self.num_heads, (x.shape[-1] // self.num_heads) ** -0.5)
        return out.to(self.dtype)

    def forward_ln(self, x: torch.Tensor, norm: LayerNorm) -> torch.Tensor:
        """attn(norm(x)) for the `ln_fused` path: `x` is the RAW residual
        stream; B2 returns its output as int8 codes + row scales, which go
        straight into the int8 output projection (bias after the cast)."""
        n, t, d = x.shape
        op = (flash_attention_ln_qkv_fused_q8_plain if self.plain
              else flash_attention_ln_qkv_fused_q8)
        qkv = self.qkv
        oq, os_ = op(x.to(torch.bfloat16).contiguous(), norm.weight,
                     norm.bias, qkv.weight_q, qkv.scale, qkv.bias,
                     self.num_heads, (d // self.num_heads) ** -0.5,
                     eps=norm.eps, qk_int8=self.qk_int8)
        p = self.proj
        return int8_matmul_prequant_act(oq, os_, p.weight_q, p.scale, p.bias,
                                        self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, _ = x.shape
        h, hd = self.num_heads, self.head_dim
        d = h * hd
        scale = hd ** -0.5
        x = copy_to_model(x, self.group)
        if self.qkv_fused:
            op = flash_attention_qkv_fused_plain if self.plain else \
                flash_attention_qkv_fused
            xq, sx = quantize_rows(x)
            qkv = self.qkv
            return self.proj(op(xq, sx, qkv.weight_q, qkv.scale, qkv.bias, h,
                                scale))
        qkv = self.qkv(x)
        if self.flat:
            if torch.is_grad_enabled():
                return row_parallel(self.proj, flash_attention_flat_fn(
                    qkv, h, scale, plain=self.plain), self.group)
            op = flash_attention_flat_plain if self.plain else \
                flash_attention_flat
            return row_parallel(self.proj, op(qkv, h, scale), self.group)
        q, k, v = qkv.reshape(n, t, 3, h, hd).unbind(2)
        s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float())
        s = s.to(self.scores_dtype) * scale
        attn = torch.softmax(s.float(), dim=-1).to(self.dtype)
        out = torch.einsum("nhqk,nkhd->nqhd", attn.float(), v.float())
        return row_parallel(self.proj, out.to(self.dtype).reshape(n, t, d),
                            self.group)


class Mlp(nn.Module):
    """fc1 -> GELU ('exact' erf or 'tanh') -> fc2; cut over a model
    group, fc1 column- and fc2 row-parallel."""

    def __init__(self, dim: int, hidden: int, dtype=torch.float32,
                 gelu: str = "exact", quant=False, device=None):
        super().__init__()
        self.approximate = "tanh" if gelu == "tanh" else "none"
        self.group = None
        self.fc1 = dense(dim, hidden, dtype, quant, device)
        self.fc2 = dense(hidden, dim, dtype, quant, device)

    def shard(self, group, n: int) -> None:
        self.group = group

    def forward(self, x):
        h = F.gelu(self.fc1(copy_to_model(x, self.group)),
                   approximate=self.approximate)
        return row_parallel(self.fc2, h, self.group)


class Block(nn.Module):
    """Pre-norm transformer block: x += attn(ln1(x)); x += mlp(ln2(x)),
    LayerNorm eps 1e-6."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None,
                 plain: bool = False):
        super().__init__()
        d = cfg.embed_dim
        quant = cfg.quant_int8
        self.dtype = dtype
        self.plain = plain
        self.norm1 = LayerNorm(d, 1e-6, dtype, device)
        self.attn = Attention(d, cfg.num_heads, dtype, cfg.attn_impl,
                              _dtype(cfg.attn_scores_dtype), quant, plain,
                              device, cfg.attn_variant, cfg.tp_layout)
        self.norm2 = LayerNorm(d, 1e-6, dtype, device)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio), dtype, cfg.mlp_gelu,
                       quant, device)
        # the whole int8 MLP with its residual inside kernel B16
        self.mlp_fused = (cfg.mlp_fused and quant == "static"
                          and cfg.mlp_gelu == "tanh")
        # the static part of the reference's LN2 + quantize gate; the
        # T % 8 part comes with each call
        self.ln_quant = (cfg.ln_quant_fused and quant == "static"
                         and not cfg.mlp_fused and d % 128 == 0)
        if self.ln_quant and cfg.mlp_act_cal:
            self.act_scale = self._scale_param(device)
            # calibration drops the site where its forward skipped the
            # branch (`ops.quant.calibrate_act_scales`)
            self.act_scale_lazy = True
            self.calibrating = False
            self.cal_amax = None

    @staticmethod
    def _scale_param(device) -> nn.Parameter:
        return nn.Parameter(torch.empty((), dtype=torch.float32,
                                        device=device), requires_grad=False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the reference declares the MLP-hidden act_scale only where its
        # branch runs, so a tree may lack it: the site follows the tree
        if hasattr(self, "act_scale_lazy"):
            if prefix + "act_scale" not in state_dict:
                self.act_scale = None
            elif self.act_scale is None:
                self.act_scale = self._scale_param(self.norm2.weight.device)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def reset_parameters(self, generator=None):
        if getattr(self, "act_scale", None) is not None:
            self.act_scale.fill_(1.0)

    def _mlp_ln_quant(self, x: torch.Tensor) -> torch.Tensor:
        """mlp(norm2(x)) with LN2 + row quantize in kernel B3 and int8
        fc1/fc2 (the reference's `ln_quant_fused` branch)."""
        n, t, d = x.shape
        dt = self.dtype
        op = ln_quantize_rows_plain if self.plain else ln_quantize_rows
        yq, sy = op(x.contiguous(), self.norm2.weight, self.norm2.bias,
                    self.norm2.eps)
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        h = (int8_matmul_preact(yq.reshape(n * t, d), sy.reshape(n * t, 1),
                                fc1.weight_q, fc1.scale, dt)
             + fc1.bias.to(dt))
        h = F.gelu(h, approximate=self.mlp.approximate)
        if hasattr(self, "act_scale") and not self.calibrating:
            if self.act_scale is None:
                raise RuntimeError(
                    "this block's MLP-hidden act_scale was never loaded or "
                    "calibrated (the calibration input's token count "
                    "skipped the LN2 + quantize branch that reads it)")
            # calibrated per-tensor scale of the GELU output
            sh = div127(torch.clamp(self.act_scale, min=EPS))
            hq = torch.clamp(torch.round(h.float() / sh), -127, 127).to(
                torch.int8)
            y = int8_matmul_preact(hq, sh.reshape(1, 1), fc2.weight_q,
                                   fc2.scale, dt)
        else:
            if hasattr(self, "act_scale"):
                # calibration keeps the dynamic math; real rows only (the
                # reference's amax also sees its pad rows)
                record_amax(self, h.float().abs().amax())
            y = int8_matmul_prequant(h, fc2.weight_q, fc2.scale, dt)
        return (y + fc2.bias.to(dt)).reshape(n, t, d)

    def _mlp_fused(self, x: torch.Tensor) -> torch.Tensor:
        """x + mlp(norm2(x)) in kernel B16 from the row-quantized LN2
        output (the reference's `mlp_fused` branch)."""
        op = mlp_fused_plain if self.plain else mlp_fused
        yq, sy = quantize_rows(self.norm2(x))
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        return op(yq, sy, x.to(torch.bfloat16).contiguous(), fc1.weight_q,
                  fc1.scale, fc1.bias, fc2.weight_q, fc2.scale,
                  fc2.bias).to(self.dtype)

    def forward(self, x: torch.Tensor, ln_quant_ok: bool = False
                ) -> torch.Tensor:
        if self.attn.ln_fused:
            x = x + self.attn.forward_ln(x, self.norm1)
        elif self.attn.qkvp_fused:
            x = self.attn.forward_qkvp(self.norm1(x), x)
        else:
            x = x + self.attn(self.norm1(x))
        if self.mlp_fused:
            return self._mlp_fused(x)
        if self.ln_quant and ln_quant_ok:
            return x + self._mlp_ln_quant(x)
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
            return patch_embed(x.float().contiguous(),
                               self.weight.to(self.dtype), self.bias,
                               self.patch)
        return patch_embed_plain(x, self.weight, self.bias, self.patch,
                                 self.dtype)


class DenseViT(nn.Module):
    """(N, H, W, 3) -> 4 tapped (N, 1 + gh*gw, D) sequences and (gh, gw)."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None,
                 plain: bool = False, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        d = cfg.embed_dim
        g0 = cfg.pretrain_grid
        self.patch_embed = PatchEmbed(d, cfg.patch_size, 3, dtype,
                                      cfg.patch_fused and not plain, device)
        self.cls_token = nn.Parameter(torch.empty(
            (1, 1, d), dtype=torch.float32, device=device),
            requires_grad=False)
        self.pos_embed = nn.Parameter(torch.empty(
            (1, 1 + g0 * g0, d), dtype=torch.float32, device=device),
            requires_grad=False)
        self.blocks = nn.ModuleList(
            Block(cfg, dtype, device, plain)
            for _ in range(cfg.hooks[-1] + 1))

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

        # the reference pads T to a multiple of 8 on its flash paths and
        # takes the LN2 + quantize branch where that T is a multiple of 8
        t = 1 + gh * gw
        if cfg.attn_impl in _PADDING_IMPLS and flat_flash_eligible(
                d, cfg.num_heads, cfg.tp_layout):
            t = -(-t // 8) * 8
        ln_quant_ok = t % 8 == 0

        taps = []
        hooks = set(cfg.hooks)
        remat = self.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            if remat:
                x = checkpoint(blk, x, ln_quant_ok, use_reentrant=False)
            else:
                x = blk(x, ln_quant_ok)
            if i in hooks:
                taps.append(x)
        return taps, (gh, gw)
