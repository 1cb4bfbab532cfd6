"""Int8 quantized paths of the fast serving config (torch port of
`lseg_tpu/ops/quant.py`).

Symmetric int8 everywhere: per-output-channel weight scales fixed at load
time by `quantize_tree` (or, for `QuantDense`, the dynamic mode of
`quant_int8=True` / 'dynamic', taken from the fp32 weight at every call by
`quantize_cols`), per-row (dense) or per-tensor (conv) activation scales
computed per call, or calibrated once (`calibrate_act_scales`) for the
`static_cal` sites. Products accumulate exactly in int32
(`torch._int_mm`, on the card and on the CPU), so every rounding point is
the reference's:

- `quantize_rows` / `quantize_tensor`: scale = max(max|x|, 1e-8) / 127
  (`div127`, an IEEE division on every device), codes
  round-half-even(x / scale) clipped to +-127;
- dense: fp32 (acc * sx) * sw, cast to the out dtype, bias added AFTER the
  cast in the out dtype (`int8_matmul_prequant_act`);
- conv: fp32 acc * (sx * sw), the scale product taken first
  (`int8_conv_prequant`); 3x3 convs run as one int8 im2col product.

Calibration: every `act_scale` site (`StaticQuantConv(static_act=True)`,
the ViT block's MLP-hidden scale) has a `calibrating` flag and records the
running max|x| in `cal_amax` while it is set, keeping the dynamic math, as
the reference's `quant_cal` sow does. `calibrate_act_scales` runs one
forward so and writes max(amax, 1e-8) into the `act_scale` parameters, in
place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lseg_tpu_torch.models.layers import lecun_normal_
from lseg_tpu_torch.ops._build import check_no_grad

EPS = 1e-8


def div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 as an IEEE division on every device: on the card PyTorch
    takes a division by a Python scalar as a product with its reciprocal,
    an ulp off the quotient at times, which moves a code at a bin edge;
    the reference and the kernels divide."""
    return x / torch.full_like(x, 127.0)


def inv127(a: torch.Tensor) -> torch.Tensor:
    """127 / a as an IEEE division on every device: PyTorch takes a Python
    scalar over a tensor as a product with the tensor's reciprocal, on the
    CPU as well, an ulp off the quotient for about a quarter of fp32
    values; the reference divides."""
    return torch.full_like(a, 127.0) / a


def _codes(xf: torch.Tensor, scale) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quantize_rows(x: torch.Tensor, eps: float = EPS):
    """(..., K) -> int8 codes with per-row fp32 scales (..., 1)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = div127(torch.clamp(amax, min=eps))
    return _codes(xf, scale), scale


def quantize_cols(w: torch.Tensor, eps: float = EPS):
    """(out, in) weight -> int8 codes with per-output-channel fp32 scales
    (out,): the reference's `quantize_cols` of its (in, out) kernel, on the
    port's (out, in) storage (each output channel is a row here)."""
    codes, scale = quantize_rows(w, eps)
    return codes, scale.reshape(-1)


def quantize_tensor(x: torch.Tensor, eps: float = EPS):
    """(...) -> int8 codes with one fp32 scale (a 0-d tensor)."""
    xf = x.float()
    scale = div127(torch.clamp(xf.abs().amax(), min=eps))
    return _codes(xf, scale), scale


def int8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K) int8 transposed -> (M, N) int32, exact.

    The (out, in) weight storage is the column-major second operand of
    `torch._int_mm`. On the card cuBLASLt wants M > 16 and K, N multiples
    of 8: zero rows and columns pad the operands there, which leaves the
    integer sums unchanged."""
    m, k = a.shape
    n = w.shape[0]
    if a.device.type == "cuda":
        pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
        if pm or pk:
            a = F.pad(a, (0, pk, 0, pm))
        if pn or pk:
            w = F.pad(w, (0, pk, 0, pn))
        return torch._int_mm(a.contiguous(), w.t())[:m, :n]
    return torch._int_mm(a.contiguous(), w.t())


def int8_matmul_preact(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                       sw: torch.Tensor,
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """dequant(xq, sx) @ dequant(wq, sw)^T: xq (..., K) int8, sx (..., 1)
    (or (1, 1)) fp32 row scales, wq (N, K) int8, sw (N,) fp32 ->
    (..., N) in `out_dtype` (the reference's `pallas_ln.int8_matmul_preact`,
    which consumes the codes of kernel B3)."""
    lead = xq.shape[:-1]
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), wq)
    y = acc.float() * sx.reshape(-1, 1) * sw.reshape(1, -1)
    return y.reshape(*lead, wq.shape[0]).to(out_dtype)


def int8_matmul_prequant_act(xq, sx, wq, sw, bias=None,
                             out_dtype: torch.dtype = torch.bfloat16):
    """`int8_matmul_preact` + bias added after the cast, in `out_dtype`."""
    y = int8_matmul_preact(xq, sx, wq, sw, out_dtype)
    return y if bias is None else y + bias.to(out_dtype)


def int8_matmul_prequant(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                         out_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """x @ dequant(wq, sw)^T with per-row dynamic int8 activations."""
    xq, sx = quantize_rows(x)
    return int8_matmul_preact(xq, sx, wq, sw, out_dtype)


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x @ w^T with both operands quantized at the call: the (out, in)
    weight per output channel (`quantize_cols`), x per row; exact int32
    sums (the reference's `int8_matmul`)."""
    wq, sw = quantize_cols(w)
    return int8_matmul_prequant(x, wq, sw, out_dtype)


def _im2col(x: torch.Tensor, k: int, stride: int, padding: int
           ) -> torch.Tensor:
    """NHWC (N, H, W, C) -> (N, Ho, Wo, k*k*C), features ordered
    (row, column, channel) like an OIHW kernel permuted to (O, H, W, I)."""
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    if k == 1 and stride == 1:
        return x
    _, h, w, _ = x.shape
    ho = (h - k) // stride + 1
    wo = (w - k) // stride + 1
    taps = [x[:, i:i + stride * (ho - 1) + 1:stride,
              j:j + stride * (wo - 1) + 1:stride]
            for i in range(k) for j in range(k)]
    return torch.cat(taps, dim=-1)


def int8_conv_prequant(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                       stride: int = 1, padding: int = 0,
                       out_dtype: torch.dtype = torch.bfloat16,
                       act_scale=None) -> torch.Tensor:
    """NHWC conv with an OIHW int8 kernel: per-tensor int8 activations
    (dynamic, or the given scale), exact int32 accumulation, fp32
    acc * (sx * sw) cast to `out_dtype`."""
    if act_scale is None:
        xq, sx = quantize_tensor(x)
    else:
        sx = act_scale
        xq = _codes(x.float(), sx)
    o, _, k, _ = wq.shape
    cols = _im2col(xq, k, stride, padding)
    n, ho, wo, kc = cols.shape
    wm = wq.permute(0, 2, 3, 1).reshape(o, kc)
    acc = int8_mm(cols.reshape(-1, kc), wm).reshape(n, ho, wo, o)
    return (acc.float() * (sx * sw)).to(out_dtype)


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class QuantDense(nn.Module):
    """Dense with the dynamic int8 product (`quant_int8=True` /
    'dynamic'): fp32 `weight` (out, in) and `bias` under `Dense`'s names,
    so checkpoints and the reference's trees load unchanged; the weight is
    quantized per output channel at every call (`int8_matmul`), the bias
    added in the out dtype after the cast. The weight stays fp32 whatever
    the compute dtype, as the reference quantizes its fp32 param: codes of
    a bf16-rounded weight would differ. Serving only (no gradient through
    the rounding): under grad a tensor that requires it raises."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _param((out_features, in_features), torch.float32,
                             device)
        self.bias = _param((out_features,), torch.float32, device)

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_no_grad("QuantDense", x, self.weight, self.bias)
        y = int8_matmul(x, self.weight, self.dtype)
        return y + self.bias.to(self.dtype)


class StaticQuantDense(nn.Module):
    """Dense with pre-quantized weights: int8 `weight_q` (out, in), fp32
    per-output-channel `scale` and fp32 `bias`; per-row dynamic int8
    activations; bias added in the out dtype after the cast."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.bfloat16, use_bias: bool = True, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight_q = _param((out_features, in_features), torch.int8,
                               device)
        self.scale = _param((out_features,), torch.float32, device)
        self.bias = (_param((out_features,), torch.float32, device)
                     if use_bias else None)

    def reset_parameters(self, generator=None):
        """The reference's placeholders (zeros / ones): real values come
        from `quantize_tree`."""
        self.weight_q.zero_()
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_matmul_prequant(x, self.weight_q, self.scale, self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class StaticQuantConv(nn.Module):
    """NHWC conv with pre-quantized weights: int8 `weight_q` (OIHW), fp32
    per-output-channel `scale`, optional fp32 `bias`. `static_act` adds the
    calibrated per-tensor `act_scale` (max|x| of the calibration data);
    without it the activation scale is max|x| of each call."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype=torch.bfloat16, static_act: bool = False,
                 device=None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.static_act = static_act
        self.weight_q = _param((out_ch, in_ch, kernel, kernel), torch.int8,
                               device)
        self.scale = _param((out_ch,), torch.float32, device)
        self.bias = _param((out_ch,), torch.float32, device) if bias else None
        if static_act:
            self.act_scale = _param((), torch.float32, device)
            self.calibrating = False
            self.cal_amax = None

    def reset_parameters(self, generator=None):
        self.weight_q.zero_()
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()
        if self.static_act:
            self.act_scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sx = None
        if self.static_act:
            if self.calibrating:
                amax = x.float().abs().amax()
                record_amax(self, amax)
                sx = div127(torch.clamp(amax, min=EPS))
            else:
                sx = div127(self.act_scale)
        y = int8_conv_prequant(x, self.weight_q, self.scale, self.stride,
                               self.padding, self.dtype, sx)
        return y if self.bias is None else y + self.bias.to(self.dtype)


def record_amax(site: nn.Module, amax: torch.Tensor) -> None:
    """Fold one calibration observation into `site.cal_amax` (running
    max, as the reference's sow with `reduce_fn=jnp.maximum`)."""
    site.cal_amax = (amax if site.cal_amax is None
                     else torch.maximum(site.cal_amax, amax))


# Transformer-block projections quantized by default, matched by the last
# two module names (the reference's `_QUANT_LEAVES`).
_QUANT_LEAVES = {("attn", "qkv"), ("attn", "proj"),
                ("mlp", "fc1"), ("mlp", "fc2")}

# Decoder/head leaves quantized with `decoder=True` (`_QUANT_CONV_LEAVES`):
# reassemble 1x1 projections and the stride-2 resample, the readout dense,
# scratch 3x3s, RCU 3x3s, fusion out_convs, and head1.
_QUANT_CONV_LEAVES = (
    {(f"reassemble{i}", "proj") for i in range(1, 5)}
    | {("reassemble4", "resample")}
    | {("readout", "project")}
    | {("scratch", f"layer{i}_rn") for i in range(1, 5)}
    | {(f"rcu{i}", f"conv{j}") for i in (1, 2) for j in (1, 2)}
    | {(f"refinenet{i}", "out_conv") for i in range(1, 5)}
    | {("head1",)}
)


def _quantize_weight(w: torch.Tensor):
    """(out, ...) weight -> (int8 codes, fp32 (out,) scales), symmetric per
    output channel: scale = max(max|w|, 1e-8) / 127 over the other axes."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(1, wf.dim())))
    scale = div127(torch.clamp(amax, min=EPS))
    return _codes(wf, scale.reshape(-1, *([1] * (wf.dim() - 1)))), scale


def quantize_tree(state, decoder: bool = False, act_scale: bool = False,
                  mlp_act_scale=None):
    """fp32 `state_dict` -> the static-int8 serving `state_dict`.

    Every `weight` of a transformer-block projection (`_QUANT_LEAVES`)
    becomes `weight_q` int8 + `scale` fp32; `decoder=True` also quantizes
    `_QUANT_CONV_LEAVES`, and
    `act_scale=True` gives each quantized conv an `act_scale` placeholder
    (1.0, filled by `calibrate_act_scales`). `mlp_act_scale` (default:
    `act_scale`) adds the block-level MLP-hidden `act_scale` to every
    transformer block. Everything else passes through unchanged."""
    if mlp_act_scale is None:
        mlp_act_scale = act_scale
    conv_leaves = _QUANT_CONV_LEAVES if decoder else set()
    out = {}
    for name, t in state.items():
        mod, _, leaf = name.rpartition(".")
        path = tuple(mod.split("."))
        is_conv = path[-2:] in conv_leaves or path[-1:] in conv_leaves
        if leaf == "weight" and (path[-2:] in _QUANT_LEAVES or is_conv):
            out[f"{mod}.weight_q"], out[f"{mod}.scale"] = _quantize_weight(t)
            if act_scale and is_conv and t.dim() == 4:
                out[f"{mod}.act_scale"] = torch.ones((), dtype=torch.float32)
        else:
            out[name] = t
    if mlp_act_scale:
        suffix = ".mlp.fc1.weight"
        for name in state:
            block = name[:-len(suffix)]
            if name.endswith(suffix) and f"{block}.attn.qkv.weight" in state:
                out.setdefault(f"{block}.act_scale",
                               torch.ones((), dtype=torch.float32))
    return out


@torch.no_grad()
def calibrate_act_scales(model: nn.Module, *args, **kwargs) -> nn.Module:
    """Fill the `act_scale` parameters of a `static_cal` model in place by
    one calibration forward `model(*args, **kwargs)`; returns the model.

    Every module with a `calibrating` flag runs its calibration branch
    (the sites keep the dynamic math and record max|x|; the LSeg head
    takes its unfused path so head1 records its input). Sites the forward
    did not reach keep their scales, except the ViT block's MLP-hidden
    site (`act_scale_lazy`): the reference declares that scale only where
    its branch runs, so an unreached one is dropped (set to None, out of
    the state_dict) and a reached one is created if it was dropped."""
    flagged = [m for m in model.modules() if hasattr(m, "calibrating")]
    sites = [m for m in flagged if hasattr(m, "cal_amax")]
    for m in sites:
        m.cal_amax = None
    for m in flagged:
        m.calibrating = True
    try:
        model(*args, **kwargs)
    finally:
        for m in flagged:
            m.calibrating = False
    for m in sites:
        if m.cal_amax is not None:
            if m.act_scale is None:
                m.act_scale = _param((), torch.float32, m.cal_amax.device)
            m.act_scale.copy_(torch.clamp(m.cal_amax.float(), min=EPS))
            m.cal_amax = None
        elif getattr(m, "act_scale_lazy", False):
            m.act_scale = None
    return model
