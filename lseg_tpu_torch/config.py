"""Typed configuration for the LSeg-TPU model family.

One parameterized family unifies the reference's duplicated `lseg_net.py` /
`lseg_net_zs.py` variants (reference: modules/models/lseg_net.py:104-226,
modules/models/lseg_net_zs.py:106-362). The backbone registry mirrors the
reference's name → (hooks, reassemble channels, text width) mapping
(reference: modules/models/lseg_net.py:119-123, lseg_blocks.py:24-55,
lseg_net_zs.py:121-129,157-162).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Dense ViT image-encoder configuration (timm-style ViT surgery).

    The encoder taps the outputs of 4 transformer blocks (`hooks`) and
    reassembles them into a multi-resolution CNN pyramid
    (reference: modules/models/lseg_vit.py:408-535).
    """

    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    hooks: Tuple[int, int, int, int] = (5, 11, 17, 23)
    # Channel widths of the 4 reassembled feature maps (post 1x1 conv).
    post_channels: Tuple[int, int, int, int] = (256, 512, 1024, 1024)
    # Spatial resampling factor of each reassembled map relative to the
    # patch-token grid: >1 = transposed-conv upsample, 1 = identity,
    # <1 = strided 3x3 conv (reference: lseg_vit.py:446-523).
    resample: Tuple[float, float, float, float] = (4.0, 2.0, 1.0, 0.5)
    readout: str = "project"  # 'ignore' | 'add' | 'project'
    # Native pretraining grid (384/patch); pos-embed is bilinearly resized
    # from this grid to the runtime grid (reference: lseg_vit.py:149-163).
    pretrain_grid: int = 24
    # attention implementation: 'xla' einsums (default), 'flash'
    # (heads-major Pallas kernel), 'flashflat' (flat-layout Pallas
    # kernel, zero layout transitions), 'flashq' (int8 qkv projection
    # fused into the flat kernel; needs quant_int8='static'),
    # 'flashlnq' (flashq + LayerNorm and per-row int8 quantize fused
    # in too — LN output never in HBM), 'flashqp'/'flash2'/'dpa'
    # (measured dead ends kept as infrastructure). Ineligible shapes
    # (head_dim != 64, odd head count, tp_layout) fall back safely.
    attn_impl: str = "xla"
    # 'float32' (safe default) or 'bfloat16' — dtype of the attention
    # score matrix; bf16 halves its HBM stream
    attn_scores_dtype: str = "float32"
    # int8 projections in attention/MLP (serving modes; v5e int8 MXU
    # runs at 2x bf16 peak). False (default) | True/'dynamic' (weights
    # quantized per call, param tree unchanged — measured slower than
    # bf16 on v5e) | 'static' (pre-quantized serving tree via
    # `lseg_tpu.ops.quant.quantize_tree`).
    quant_int8: Any = False
    # MLP GELU: 'exact' (erf; timm/torch parity, default) or 'tanh'
    # (~12% faster end to end on v5e; validate mIoU before adopting)
    mlp_gelu: str = "exact"
    # fused int8 MLP Pallas kernel (fc1+GELU+requant+fc2+residual in
    # VMEM; needs quant_int8='static' and mlp_gelu='tanh' — falls back
    # to the unfused path otherwise)
    mlp_fused: bool = False
    # fused LayerNorm2 + per-row int8 quantize Pallas pass before the
    # MLP (ops/pallas_ln.py; needs quant_int8='static' and a sublane-
    # aligned token count — falls back to the XLA LN+quantize chain
    # otherwise). Pairs with attn_impl='flashlnq', which fuses LN1 into
    # the attention kernel.
    ln_quant_fused: bool = False
    # calibrated static per-tensor int8 scale for the MLP GELU hidden
    # (the `act_scale` block param, filled by
    # ops.quant.calibrate_act_scales): fc1's epilogue emits int8
    # directly, removing the (N*T, 4D) bf16 round trip + the separate
    # row-max/convert pass of the dynamic per-row path. Active only in
    # the ln_quant_fused static branch; calibration forwards keep the
    # exact dynamic math. Accuracy class: static PTQ (same as
    # decoder_quant='static_cal') — covered by the trained-model mIoU
    # gates.
    mlp_act_cal: bool = False
    # flat flash kernel interior variant: 'v1' (per-head chains),
    # 'v2' (stage-separated heads + exp2 — scheduler can overlap one
    # head's softmax VPU work with the other's MXU matmuls), 'i8qk'
    # (int8 QK; measured worse), 'lean' (flashlnq only: softmax
    # scale folded into the q dequant scales + pad-key mask as a
    # precomputed bias-row add — two fewer VPU passes over each
    # (T, T) score matrix), 'lx2' (lean + log2(e) fold, bare exp2
    # softmax), or 'quad' (flashlnq only, heads % 4 == 0: two pairs
    # per grid step — half the grid steps, identical arithmetic)
    attn_variant: str = "v1"
    # fused Pallas patchify+embed kernel (ops/pallas_patch.py): avoids
    # XLA's lane-hostile patchify relayout (~0.45 -> ~0.3 ms at the
    # flagship shape). fp32-reassociation delta <= 1 output bf16 ulp —
    # fast-serving opt-in; the parity path keeps the XLA matmul form.
    patch_fused: bool = False
    # q row-block size of the flat flash-attention kernel (the kernel
    # clamps to T; 1024 = single q block at the 480-crop T=901, the
    # measured best: 152.6 vs 145.8 (bq 256) img/s on v5e)
    attn_block_q: int = 1024
    # head-major attention param layout (kernel (D,3,H,hd) / (H,hd,D))
    # for tensor parallelism: the head axis becomes a real param axis,
    # so TP sharding stays collective-free through attention. Convert
    # flat checkpoints with utils.checkpoint_convert.to_tp_layout.
    tp_layout: bool = False
    # run the whole depth as ONE scan (params under vit/segall, every
    # block output streamed as a scan y, taps gathered by static
    # slicing) instead of 4 hook-bounded segments (vit/seg0..3). Trades
    # one extra (N,T,D) HBM write per block for 3 fewer XLA loop peels
    # (the 4x ~0.33 ms peeled first-iteration LayerNorm fusions).
    # Convert segment params with utils.checkpoint_convert.
    # segments_to_single_scan.
    single_scan: bool = False
    # lax.scan unroll factor for the block segments (params stay
    # STACKED — checkpoint-compatible). unroll >= segment length
    # removes the XLA while loop entirely: no first-iteration peel and
    # no per-iteration weight-slice copies, at the cost of a larger
    # program. Serving A/B knob (scripts/ab_tpu.py int8_cf_unroll).
    scan_unroll: int = 1


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """ResNet backbone configuration for the RN101 variant
    (reference: modules/models/lseg_vit_zs.py:742-761)."""

    layers: Tuple[int, int, int, int] = (3, 4, 23, 3)
    stage_channels: Tuple[int, int, int, int] = (256, 512, 1024, 2048)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text-tower configuration (OpenAI CLIP text transformer)."""

    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    embed_dim: int = 512  # output projection dim


# Text towers used by the reference's backbone registry.
CLIP_TEXT_VITB32 = CLIPTextConfig()  # clip.load("ViT-B/32") text tower
CLIP_TEXT_RN50X16 = CLIPTextConfig(width=768, heads=12, embed_dim=768)
CLIP_TEXT_RN50X4 = CLIPTextConfig(width=640, heads=10, embed_dim=640)


@dataclasses.dataclass(frozen=True)
class LSegConfig:
    """Full LSeg model configuration.

    `arch_option`/`block_depth`/`activation` select the optional spatial
    regularization blocks (reference: modules/models/lseg_net.py:148-156);
    `use_bn` enables BatchNorm inside fusion blocks (always True via
    LSegNet, reference: lseg_net.py:213).
    """

    backbone: str = "clip_vitl16_384"
    features: int = 256
    out_c: int = 512  # pixel/text embedding dim
    arch_option: int = 0  # 0=none, 1=bottleneck_block, 2=depthwise_block
    block_depth: int = 0
    activation: str = "lrelu"  # 'relu' | 'lrelu' | 'tanh'
    use_bn: bool = True
    readout: str = "project"
    # logit temperature: exp(log(1/0.07)); a *constant* in the reference
    # (non-leaf `nn.Parameter(...).exp()`, lseg_net.py:141)
    logit_scale: float = 1.0 / 0.07
    # compute dtype of the correlation + output-upsample head:
    # 'float32' (parity default) or 'bfloat16' (fast serving — halves
    # the (N, H/2, W/2, K) logit streams)
    head_dtype: str = "float32"
    # int8 decoder/head1 convs (serving knob, like vit.quant_int8):
    # False (default) | 'static' (pre-quantized int8 conv kernels via
    # `quantize_tree(..., decoder=True)`, dynamic per-tensor activation
    # scales) | 'static_cal' (calibrated activation scales via
    # `ops.quant.calibrate_act_scales` — removes the per-call max|x|
    # HBM passes). The decoder's 3x3 256-ch convs measure ~100% of the
    # bf16 MXU roofline (scripts/conv_ab.py) so the int8 MXU rate is
    # the only lever left there.
    decoder_quant: Any = False
    # fused head1+correlation Pallas kernel (int8 1x1 projection +
    # deferred-norm cosine logits in one VMEM pass; the (N,H/2,W/2,E)
    # embedding map never hits HBM). Needs decoder_quant static* and
    # head_dtype bfloat16; falls back otherwise. Values: False | True |
    # 'wup' (in-kernel W-interp; measured dead end) | 'lowres' (argmax
    # serving only, needs decoder_conv_first: head1+correlate run at
    # H/4 on refinenet1's PRE-upsample output and only the (.., K)
    # logit map is x2-upsampled before the argmax — the upsample and
    # the head matmuls commute exactly, and the skipped per-pixel norm
    # is argmax-invariant; 30.4 vs 31.3 ms/b8 interleaved r4.
    # Non-argmax calls behave as True).
    head_fused: Any = False
    # fused upsample2x + quantize + 1x1 out_conv Pallas kernel for the
    # FeatureFusionBlock tails (ops/pallas_decoder). Serving knob:
    # requires decoder_quant='static_cal' (the quantize grid must be a
    # calibrated constant); at refinenet1 it also hands the fused head
    # its int8 input directly. Ineligible shapes fall back per block.
    decoder_fused_tail: bool = False
    # fully fused int8 ResidualConvUnit Pallas kernel (relu+quantize+
    # conv1+BN+relu+quantize+conv2+BN+residual in VMEM; ~470 MB of HBM
    # round-trips per RCU at the refinenet1 shape on the XLA chain).
    # Serving knob, static_cal only, per-shape fallback.
    decoder_fused_rcu: bool = False
    # run refinenet1's out_conv BEFORE its x2 upsample (exact linear
    # commute, see FeatureFusionBlock.conv_first): the conv + its
    # activation quantize run on 4x fewer pixels and one of the two
    # int8 relayout copies between the decoder and the fused head
    # disappears. Serving knob; the parity path keeps the reference
    # op order (lseg_blocks.py:341-357).
    decoder_conv_first: bool = False
    # run the refinenet x2 interp matmuls over merged-dim rank-3 views
    # (ops/resize.py collapse=True): identical contraction, but the rhs
    # arrives contraction-major/free-minor so XLA can skip the rank-4
    # form's operand relayout copies (HLO census round 5). Serving knob.
    decoder_resize_collapse: bool = False
    vit: Optional[ViTConfig] = None
    resnet: Optional[ResNetConfig] = None
    text: CLIPTextConfig = CLIP_TEXT_VITB32

    @property
    def is_vit(self) -> bool:
        return self.vit is not None


def _vitl16(**kw) -> LSegConfig:
    return LSegConfig(
        vit=ViTConfig(),
        **kw,
    )


def _vitb16(**kw) -> LSegConfig:
    # ViT-B/16 (the reference's unwired clip_vitb16_384 transplant
    # factory, lseg_vit_zs.py:661-715; timm vit_base_patch16_384):
    # completes the CLIP->timm transplant story alongside the tested
    # convert_clip_visual_to_vit path.
    return LSegConfig(
        vit=ViTConfig(
            patch_size=16,
            embed_dim=768,
            depth=12,
            num_heads=12,
            hooks=(2, 5, 8, 11),
            post_channels=(96, 192, 384, 768),
            resample=(4.0, 2.0, 1.0, 0.5),
            pretrain_grid=24,
        ),
        **kw,
    )


def _vitb32(**kw) -> LSegConfig:
    return LSegConfig(
        vit=ViTConfig(
            patch_size=32,
            embed_dim=768,
            depth=12,
            num_heads=12,
            hooks=(2, 5, 8, 11),
            post_channels=(96, 192, 384, 768),
            resample=(8.0, 4.0, 2.0, 1.0),
            pretrain_grid=12,
        ),
        **kw,
    )


# Backbone registry; names match the reference CLI flags exactly
# (reference: lseg_blocks.py:24-55, lseg_net_zs.py:121-129).
BACKBONES = {
    "clip_vitl16_384": _vitl16(backbone="clip_vitl16_384"),
    "clipRN50x16_vitl16_384": _vitl16(
        backbone="clipRN50x16_vitl16_384", out_c=768, text=CLIP_TEXT_RN50X16
    ),
    "clipRN50x4_vitl16_384": _vitl16(
        backbone="clipRN50x4_vitl16_384", out_c=640, text=CLIP_TEXT_RN50X4
    ),
    "clip_vitb16_384": _vitb16(backbone="clip_vitb16_384"),
    "clip_vitb32_384": _vitb32(backbone="clip_vitb32_384"),
    "clipRN50x16_vitb32_384": _vitb32(
        backbone="clipRN50x16_vitb32_384", out_c=768, text=CLIP_TEXT_RN50X16
    ),
    "clipRN50x4_vitb32_384": _vitb32(
        backbone="clipRN50x4_vitb32_384", out_c=640, text=CLIP_TEXT_RN50X4
    ),
    "clip_resnet101": LSegConfig(
        backbone="clip_resnet101", resnet=ResNetConfig()
    ),
    # Test-only backbone (NOT in the reference CLI): a tiny ViT whose
    # reference-format checkpoint fits in a few MB, so the
    # real-checkpoint drill (tests/test_ckpt_drill.py) can exercise the
    # FULL artifact path — Lightning zip-pickle .ckpt file -> converter
    # -> forward -> parity_check.py / demo.py — in seconds. Every
    # converter/loader line it runs is the same code the flagship
    # checkpoints use.
    "tiny_vit_test": LSegConfig(
        backbone="tiny_vit_test",
        features=32,
        out_c=64,
        vit=ViTConfig(
            patch_size=16,
            embed_dim=64,
            depth=4,
            num_heads=2,
            hooks=(0, 1, 2, 3),
            post_channels=(16, 32, 64, 64),
            resample=(4.0, 2.0, 1.0, 0.5),
            pretrain_grid=4,
        ),
        text=CLIPTextConfig(
            vocab_size=1024, context_length=77, width=32, layers=2,
            heads=2, embed_dim=64,
        ),
    ),
}


def flat_flash_eligible(dim: int, num_heads: int,
                        tp_layout: bool) -> bool:
    """Eligibility for the flat-layout Pallas flash kernels
    (attn_impl in flashflat/flashq/flashqp): head_dim must be 64 (each
    128-lane column block of the flat qkv tensor = exactly two heads),
    the head count even, and the params in the flat (non-TP) layout.

    This single predicate gates BOTH the kernel dispatch in
    models/vit.py (Attention/Block) and the sublane token padding in
    DenseViT, so an ineligible config (e.g. tp_layout=True) can never
    pad the sequence and then run unmasked XLA attention over the pad
    rows."""
    return (num_heads > 0 and dim % num_heads == 0
            and dim // num_heads == 64 and num_heads % 2 == 0
            and not tp_layout)


def fast_serving(cfg: LSegConfig, quant: Any = False) -> LSegConfig:
    """The documented fast-serving configuration (bench.py's config).

    Parity config (the default everywhere else): exact erf GELU, fp32
    attention scores, fp32 correlation/upsample head — matches the
    reference bit-for-bit modulo bf16 matmul rounding.

    Fast config (this): measured, bounded-drift serving knobs —
    - the flat-layout Pallas flash attention kernel (145.9 vs 114.0
      img/s end to end on v5e, round 2 — fp32 scores in VMEM, so it is
      numerically STRONGER than the bf16-score XLA stream it replaces;
      model-level drift test in tests/test_quant.py); XLA bf16 scores
      remain the fallback for head_dim != 64;
    - tanh-approx GELU (~12%; drift quantified at model level in
      tests/test_quant.py::test_tanh_gelu_drift_is_small);
    - bf16 correlation+upsample head (+3.7%; argmax agreement vs the
      fp32 head tested in tests/test_quant.py).
    `quant` in ('static', 'static_cal') additionally enables the
    pre-quantized int8 paths (serve the tree through
    `lseg_tpu.ops.quant.quantize_tree(..., decoder=True)`):
    - transformer projections — with the flash kernel moving attention
      off the critical path, int8 matmuls WIN: 174.2 vs 152.5 img/s
      (it was a tie when attention dominated);
    - decoder/head1 convs + bf16 fusion upsamples — 197 vs 193 img/s
      (the decoder convs were already at ~100% of the bf16 conv
      roofline, so the int8 MXU rate is the only lever there);
    - 'static_cal': calibrated per-tensor activation scales for the
      decoder convs (`ops.quant.calibrate_act_scales`) — removes the
      per-call max|x| HBM passes: 204.9 vs 196.9 img/s (+4%).
    The bf16 head also defers the per-pixel L2 norm to after the
    correlation matmul (exact reassociation, +2.8%).

    evaluate.py defaults to parity and opts into this via `--fast`.
    """
    if quant not in (False, None, "static", "static_cal"):
        raise ValueError(
            "fast_serving quant must be False, 'static' or 'static_cal'"
            f", got {quant!r} (a bare truthy value would silently skip "
            "the decoder int8 + fused-head paths)")
    vit = cfg.vit
    if vit is not None:
        use_flashflat = flat_flash_eligible(
            vit.embed_dim, vit.num_heads, vit.tp_layout)
        # flashlnq = LN1 + int8 row-quantize + qkv projection fused INTO
        # the flash kernel (31.75 vs 33.47 ms/b8 over flashq,
        # interleaved A/B r3); flashflat for unquantized fast serving;
        # XLA fallback otherwise. ln_quant_fused adds the LN2+quantize
        # Pallas pass (34.8 vs 36.0 ms on top of flashlnq) — both
        # self-gate on shape eligibility inside Block.
        impl = vit.attn_impl
        if use_flashflat:
            impl = "flashlnq" if quant else "flashflat"
        vit = dataclasses.replace(
            vit,
            attn_impl=impl,
            # quad: two head-pairs per flashlnq grid step — half the
            # grid steps, bit-identical arithmetic (exact-match parity
            # test); 29.62-29.67 vs 29.75-29.82 ms/b8 interleaved,
            # consistent across reps (r5). Attention self-gates on
            # heads % 4 inside Attention.
            attn_variant="quad" if (quant and use_flashflat
                                    and vit.attn_variant == "v1")
            else vit.attn_variant,
            attn_scores_dtype="bfloat16",
            mlp_gelu="tanh",
            quant_int8="static" if quant else vit.quant_int8,
            ln_quant_fused=(bool(quant) or vit.ln_quant_fused)
            if use_flashflat else vit.ln_quant_fused,
            # calibrated static MLP-hidden act scale (needs the
            # static_cal calibration pass): fc1 emits int8 directly —
            # 29.35 vs 29.86 ms/b8 interleaved (r4)
            mlp_act_cal=(quant == "static_cal" and use_flashflat)
            or vit.mlp_act_cal,
            patch_fused=True,
            # fully unroll the segment scans (hook segments are <= 8
            # blocks on every registered backbone): no XLA while loop,
            # so no first-iteration peel and no per-iteration
            # weight-slice copies. 29.89 vs 30.48 ms/b8 interleaved
            # (r4); params stay stacked (checkpoint-compatible).
            # Serving-only: training keeps scan (remat + compile time).
            scan_unroll=8,
        )
    return dataclasses.replace(
        cfg, vit=vit, head_dtype="bfloat16",
        decoder_quant=quant if quant else cfg.decoder_quant,
        # fused int8 head1+correlation kernel (215.0 vs 208.5 img/s —
        # the pixel-embedding map never hits HBM); needs the int8 tree.
        # 'lowres': in argmax serving the correlation runs at H/4 and
        # only the logit map upsamples (30.4 vs 31.3 ms/b8, r4)
        head_fused="lowres" if quant else False,
        # refinenet1 out_conv BEFORE its x2 upsample (exact linear
        # commute): 33.68 vs 34.76 ms/b8 interleaved (r4), and 32.56
        # combined with the half-res-argmax serving head
        decoder_conv_first=bool(quant),
    )


def get_config(
    backbone: str,
    features: int = 256,
    arch_option: int = 0,
    block_depth: int = 0,
    activation: str = "lrelu",
    use_bn: bool = True,
) -> LSegConfig:
    """Look up a backbone config and apply the model-specific knobs the
    reference exposes on the CLI (reference: lseg_module.py:112-183)."""
    base = BACKBONES[backbone]
    return dataclasses.replace(
        base,
        features=features,
        arch_option=arch_option,
        block_depth=block_depth,
        activation=activation,
        use_bn=use_bn,
    )
