"""The fused int8 transformer block (`fast_serving(cfg, 'static_cal')` with
`attn_impl='flashqp'`, `mlp_fused=True` and `mlp_act_cal=False`) against
the JAX package's: the plain twins of kernels B16 (`mlp_fused`), B15
(`flash_attention_qkvp_fused`) and B9 (`flash_attention_ln_qkv_fused`)
against the Pallas kernels in interpret mode at two head pairs, the
routing of both options, one block, the ViT and the tiny LSeg model on
carried-across trees, the MLP-hidden `act_scale` of a `flashqp` tree at a
token count that skips its branch, and the `gpu`-marked checks of the
CUDA kernels against their plain versions. The flax models of the JAX
package are imported inside the tests that use them: the card machine
has JAX but no flax."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    assert_bf16_bound,
    cuda_device,
    f32,
    fp32_reference_of,
    inputs,
    jax_lseg_variables,
    tiny_parity_config,
)

from lseg_tpu.config import fast_serving
from lseg_tpu.ops.pallas_attention import (
    flash_attention_ln_qkv_fused as j_ln_qkv_fused,
)
from lseg_tpu.ops.pallas_attention import (
    flash_attention_qkvp_fused as j_qkvp_fused,
)
from lseg_tpu.ops.pallas_mlp import mlp_fused as j_mlp_fused
from lseg_tpu.testing import tiny_vit_config
from lseg_tpu_torch.engine.variant_tree import ROOT, VARIANTS
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.models.vit import Block, DenseViT
from lseg_tpu_torch.ops.flash_attention import (
    _flat_attention_f32,
    _qkv_plain,
    flash_attention_ln_qkv_fused,
    flash_attention_ln_qkv_fused_plain,
    flash_attention_qkvp_fused,
    flash_attention_qkvp_fused_plain,
)
from lseg_tpu_torch.ops.mlp import (
    check_kernel_widths,
    mlp_fused,
    mlp_fused_plain,
)
from lseg_tpu_torch.ops.quant import (
    _codes,
    calibrate_act_scales,
    int8_mm,
    quantize_rows,
    quantize_tree,
)
from lseg_tpu_torch.utils.convert import from_jax_variables

SCALE = 64 ** -0.5
# one bf16 ulp of |ref| (2^-7 relative at most): a real residual adds up
# to one rounding step of the sum to what the fused work leaves
BF16_ULP = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def fused_block_config(base):
    """The fused block on `base`: fast_cal with B15 and B16, no
    MLP-hidden calibration (the reference declares no such site under
    `mlp_fused`)."""
    cfg = fast_serving(base, "static_cal")
    return dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, attn_impl="flashqp", mlp_fused=True, mlp_act_cal=False))


def _resid(rng, shape, kind):
    if kind == "zero":
        return np.zeros(shape, np.float32)
    return (rng.randn(*shape) * 2.0).astype(np.float32)


def _bf16(a):
    """numpy fp32 values on the bf16 grid (the kernels' residual type)."""
    return f32(jnp.asarray(a, jnp.bfloat16))


def _assert_within(got, ref, rel, resid_kind, what):
    """|got - ref| <= rel * max|ref|, plus one bf16 ulp of |ref| where the
    residual is real."""
    err = np.abs(got - ref)
    tol = rel * float(np.abs(ref).max())
    if resid_kind == "real":
        tol = tol + BF16_ULP * np.abs(ref)
    bad = int((err > tol).sum())
    print(f"{what}: max |port - jax| {err.max():.4g}, max|ref| "
          f"{np.abs(ref).max():.4g}, over tolerance {bad}")
    assert bad == 0, (what, float(err.max()))


# ---- B16: the fused int8 MLP ----

def _mlp_inputs(seed, n, t, d=256, h=1024, resid_kind="zero"):
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (n, t, d)).astype(np.int8)
    sx = (rng.rand(n, t, 1) * 0.02 + 0.005).astype(np.float32)
    w1 = rng.randint(-127, 128, (d, h)).astype(np.int8)     # JAX (D, H)
    s1 = (rng.rand(h) * 2e-3 / np.sqrt(d)).astype(np.float32)
    b1 = (rng.randn(h) * 0.5).astype(np.float32)
    w2 = rng.randint(-127, 128, (h, d)).astype(np.int8)     # JAX (H, D)
    s2 = (rng.rand(d) * 2e-2 / np.sqrt(h)).astype(np.float32)
    b2 = (rng.randn(d) * 0.05).astype(np.float32)
    resid = _bf16(_resid(rng, (n, t, d), resid_kind))
    return xq, sx, resid, w1, s1, b1, w2, s2, b2


def _mlp_port_args(xq, sx, resid, w1, s1, b1, w2, s2, b2):
    return (_t(xq), _t(sx), _t(resid).bfloat16(),
            _t(np.ascontiguousarray(w1.T)), _t(s1), _t(b1),
            _t(np.ascontiguousarray(w2.T)), _t(s2), _t(b2))


@pytest.mark.parametrize("t,resid_kind", [(40, "zero"), (40, "real"),
                                          (300, "zero"), (300, "real")])
def test_mlp_fused_plain_matches_pallas(t, resid_kind):
    """(2, T, 256), H = 1024; T = 300 tiles the rows as 256 + a ragged 44.
    With a zero residual the fused work within 1e-2 of max|ref| (the GELU
    is the same tanh formula in another rounding order, so a hidden code
    may sit one level off at a .5 boundary); with a real residual that
    plus one bf16 ulp of the sum."""
    a = _mlp_inputs(t, 2, t, resid_kind=resid_kind)
    xq, sx, resid, *w = a
    ref = f32(j_mlp_fused(jnp.asarray(xq), jnp.asarray(sx),
                          jnp.asarray(resid, jnp.bfloat16),
                          *[jnp.asarray(v) for v in w], interpret=True))
    args = _mlp_port_args(*a)
    got = mlp_fused_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    _assert_within(got.float().numpy(), ref, 1e-2, resid_kind,
                   f"mlp_fused T={t} {resid_kind} residual")
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(mlp_fused(*args).float().numpy(),
                                  got.float().numpy())


def _mlp_cluster_emulated(xq, sx, resid, w1q, s1, b1, w2q, s2, b2,
                          own_amax=False):
    """Kernel B16's cluster decomposition (csrc/mlp_fused.cu) in torch on
    the CPU. Rows in 64-row tiles, padded with zero codes and scales (TMA's
    zero fill; the pad rows are never stored); per tile the C = D / 128
    CTAs each own 512 hidden and 128 output columns: fc1 of the slice
    exact in int32, dequant and GELU at the plain version's rounding
    points, the slice's row maxima; sh from the maximum of the C partials
    (with `own_amax`, from the CTA's own slice alone, the exchange cut
    out); each slice's codes with that sh; fc2 of each CTA's columns over
    the 128-deep k-chunks of all slices' codes in the kernel's order (its
    own first), summed in int32; the epilogue with the CTA's sh."""
    n, t, d = xq.shape
    c_n = d // 128
    m = n * t
    pad = -m % 64
    x = torch.nn.functional.pad(xq.reshape(m, d), (0, 0, 0, pad))
    sxp = torch.nn.functional.pad(sx.reshape(m, 1), (0, 0, 0, pad))
    out = []
    for r0 in range(0, m + pad, 64):
        rows = slice(r0, r0 + 64)
        g, part = [], []
        for r in range(c_n):
            cols = slice(512 * r, 512 * r + 512)
            h = (int8_mm(x[rows], w1q[cols]).float() * sxp[rows]
                 * s1[cols] + b1[cols])
            g.append(torch.nn.functional.gelu(h, approximate="tanh"))
            part.append(g[-1].abs().amax(-1, keepdim=True))
        amax = torch.stack(part).amax(0)
        sh = [torch.clamp(part[r] if own_amax else amax, min=1e-8) / 127.0
              for r in range(c_n)]
        codes = torch.cat([_codes(g[r], sh[r]) for r in range(c_n)], -1)
        tile = []
        for r in range(c_n):
            dcols = slice(128 * r, 128 * r + 128)
            acc = torch.zeros(64, 128, dtype=torch.int32)
            for it in range(4 * c_n):
                k0 = 128 * ((4 * r + it) % (4 * c_n))
                k = slice(k0, k0 + 128)
                acc += int8_mm(codes[:, k].contiguous(),
                               w2q[dcols, k].contiguous())
            tile.append(acc.float() * sh[r] * s2[dcols] + b2[dcols])
        out.append(torch.cat(tile, -1))
    y = torch.cat(out)[:m]
    return (y + resid.reshape(m, d).float()).to(torch.bfloat16).reshape(
        n, t, d)


@pytest.mark.parametrize("d", [1024, 768])
def test_b16_cluster_decomposition_emulated(d):
    """At ViT-L/16's (1024, 4096) and ViT-B's (768, 3072) widths (clusters
    of 8 and 6 CTAs), 70 rows (a 64-row tile and a ragged 6) with a real
    residual and eight outlier hidden channels of graded size, one in each
    eighth of H, as `chip_smoke.py` feeds the card: the kernel's cluster
    decomposition equals `mlp_fused_plain` bit for bit (the int32 sums are
    exact in any order and the max of the slices' maxima is the row's);
    with each CTA's amax taken over its own slice alone it differs."""
    xq, sx, resid, w1, s1, b1, w2, s2, b2 = _mlp_inputs(
        7, 1, 70, d, 4 * d, "real")
    h = 4 * d
    b1[h // 16::h // 8] += np.arange(1.0, 9.0, dtype=np.float32)
    args = _mlp_port_args(xq, sx, resid, w1, s1, b1, w2, s2, b2)
    ref = mlp_fused_plain(*args)
    assert torch.equal(_mlp_cluster_emulated(*args), ref)
    assert not torch.equal(_mlp_cluster_emulated(*args, own_amax=True), ref)


@pytest.mark.parametrize("d,h,ok", [(1024, 4096, True), (768, 3072, True),
                                    (128, 512, True), (1024, 3072, False),
                                    (1152, 4608, False), (64, 256, False),
                                    (320, 1280, False)])
def test_mlp_fused_kernel_widths(d, h, ok):
    """The kernel's width contract (a cluster of D / 128 <= 8 CTAs, each
    owning 128 output and 512 hidden columns): ViT-L/16's and ViT-B's MLP
    widths pass, and a width outside it raises a ValueError that names the
    contract; the wrapper checks it before a card launch."""
    if ok:
        check_kernel_widths(d, h)
    else:
        with pytest.raises(ValueError, match="H = 4 D with D a multiple"):
            check_kernel_widths(d, h)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_tree_substitutions_match_the_sources(name):
    """Each variant of `engine.variant_tree` (the alternatives and the
    mutations the card's checks are run against) still finds every text
    it replaces in its kernel source."""
    source, subs = VARIANTS[name]
    text = (ROOT / "lseg_tpu_torch" / "csrc" / source).read_text()
    for old, _ in subs:
        assert old in text, old


# ---- B15: the whole int8 attention half-block ----

def _qkvp_inputs(seed, n=2, t=40, d=256, resid_kind="zero"):
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (n, t, d)).astype(np.int8)
    sx = (rng.rand(n, t, 1) * 0.02 + 0.005).astype(np.float32)
    wq = rng.randint(-127, 128, (d, 3 * d)).astype(np.int8)   # JAX (D, 3D)
    sw = (rng.rand(3 * d) * 1e-3 + 1e-4).astype(np.float32)
    bias = (rng.randn(3 * d) * 0.05).astype(np.float32)
    wp = rng.randint(-127, 128, (d, d)).astype(np.int8)       # JAX (D, D)
    sp = (rng.rand(d) * 2e-2 / np.sqrt(d)).astype(np.float32)
    bp = (rng.randn(d) * 0.05).astype(np.float32)
    resid = _bf16(_resid(rng, (n, t, d), resid_kind))
    return xq, sx, wq, sw, bias, wp, sp, bp, resid


def _qkvp_port_args(xq, sx, wq, sw, bias, wp, sp, bp, resid):
    return (_t(xq), _t(sx), _t(np.ascontiguousarray(wq.T)), _t(sw),
            _t(bias), _t(np.ascontiguousarray(wp.T)), _t(sp), _t(bp),
            _t(resid).bfloat16())


@pytest.mark.parametrize("valid_len,resid_kind", [
    (40, "zero"), (40, "real"), (33, "zero"), (33, "real")])
def test_flash_attention_qkvp_fused_plain_matches_pallas(valid_len,
                                                         resid_kind):
    """(2, 40, 256), 4 heads = two pairs, so the per-pair row scales and
    the cross-pair sum both count; every key valid, and keys masked past
    valid_len. A zero residual within 2e-2 of max|ref| (P rounds to bf16
    on both sides and a code may sit one level off); a real residual
    within that plus one bf16 ulp of the sum."""
    a = _qkvp_inputs(valid_len, resid_kind=resid_kind)
    xq, sx, wq, sw, bias, wp, sp, bp, resid = a
    ref = f32(j_qkvp_fused(
        jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(wq), jnp.asarray(sw),
        jnp.asarray(bias), jnp.asarray(wp), jnp.asarray(sp), jnp.asarray(bp),
        jnp.asarray(resid, jnp.bfloat16), 4, SCALE, interpret=True,
        valid_len=valid_len))
    args = _qkvp_port_args(*a) + (4, SCALE, valid_len)
    got = flash_attention_qkvp_fused_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    _assert_within(got.float().numpy(), ref, 2e-2, resid_kind,
                   f"qkvp valid_len={valid_len} {resid_kind} residual")
    np.testing.assert_array_equal(
        flash_attention_qkvp_fused(*args).float().numpy(),
        got.float().numpy())


def _qkvp_tiles_emulated(xq, sx, wq, sw, bias, wp, sp, bp, resid,
                         num_heads, scale, valid_len=None, pair0_scale=False):
    """Kernel B15 (csrc/flash_attention_qkvp_fused.cu) in torch on the CPU:
    the plain qkv and fp32 attention, the pair interior's per-(row, pair)
    codes and scales, then the projection as the kernel tiles it: rows in
    128-row tiles padded with zero codes (TMA's zero fill; the pad rows
    read a scale of 0 and are never stored), 128 output columns a tile;
    per pair (one 128-deep k-chunk) the exact int32 sum, flushed into the
    fp32 accumulator as (acc * sa[row, p]) * sp[col], (part_0 + bp) +
    resid for the first pair and += part_p after it; one cast to bf16.
    With `pair0_scale` every pair is flushed with pair 0's row scale."""
    n, t, d = xq.shape
    m = n * t
    att = _flat_attention_f32(_qkv_plain(xq, sx, wq, sw, bias), num_heads,
                              scale, valid_len)[0].reshape(m, d)
    pairs = d // 128
    codes, scales = zip(*(quantize_rows(att[:, 128 * p:128 * p + 128])
                          for p in range(pairs)))
    pad = -m % 128
    aq = torch.nn.functional.pad(torch.cat(codes, -1), (0, 0, 0, pad))
    sa = torch.nn.functional.pad(torch.cat(scales, -1), (0, 0, 0, pad))
    res = torch.nn.functional.pad(resid.reshape(m, d).float(),
                                  (0, 0, 0, pad))
    out = torch.empty(m + pad, d)
    for r0 in range(0, m + pad, 128):
        rows = slice(r0, r0 + 128)
        for c0 in range(0, d, 128):
            cols = slice(c0, c0 + 128)
            f = None
            for p in range(pairs):
                k = slice(128 * p, 128 * p + 128)
                acc = int8_mm(aq[rows, k].contiguous(),
                              wp[cols, k].contiguous())
                sr = sa[rows, 0 if pair0_scale else p].reshape(-1, 1)
                part = acc.float() * sr * sp[cols]
                f = (part + bp[cols] + res[rows, cols] if f is None
                     else f + part)
            out[rows, cols] = f
    return out[:m].to(torch.bfloat16).reshape(n, t, d)


@pytest.mark.parametrize("d,resid_kind", [(256, "real"), (768, "zero"),
                                          (768, "real")])
def test_b15_projection_tiles_emulated(d, resid_kind):
    """ViT-B's width (6 pairs) and two pairs, 130 rows (a 128-row tile and
    a ragged 2), keys masked past 100: the kernel's tiled projection with
    its per-pair flushes equals `flash_attention_qkvp_fused_plain` bit for
    bit (the int32 sums are exact, and each flush rounds at the plain
    version's points in its pair order); flushing every pair with pair 0's
    scale differs."""
    a = _qkvp_inputs(11, 1, 130, d, resid_kind)
    args = _qkvp_port_args(*a) + (d // 64, SCALE, 100)
    ref = flash_attention_qkvp_fused_plain(*args)
    assert torch.equal(_qkvp_tiles_emulated(*args), ref)
    assert not torch.equal(_qkvp_tiles_emulated(*args, pair0_scale=True),
                           ref)


# ---- B9: LayerNorm + int8 qkv + attention, bf16 out ----

def _ln_qkv_inputs(seed, n=2, t=40, d=256):
    rng = np.random.RandomState(seed)
    x = _bf16(rng.randn(n, t, d) * 2.0)
    g = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    wq = rng.randint(-127, 128, (d, 3 * d)).astype(np.int8)
    sw = (rng.rand(3 * d) * 1e-3 + 1e-4).astype(np.float32)
    bias = (rng.randn(3 * d) * 0.05).astype(np.float32)
    return x, g, b, wq, sw, bias


def _ln_qkv_port_args(x, g, b, wq, sw, bias):
    return (_t(x).bfloat16(), _t(g), _t(b), _t(np.ascontiguousarray(wq.T)),
            _t(sw), _t(bias))


@pytest.mark.parametrize("valid_len", [40, 33])
def test_flash_attention_ln_qkv_fused_plain_matches_pallas(valid_len):
    """(2, 40, 256), 4 heads: bf16 within 2e-2 of max|ref| (an LN code may
    sit one level off at a bin edge, and P rounds to bf16 on both
    sides)."""
    x, g, b, wq, sw, bias = _ln_qkv_inputs(5)
    ref = f32(j_ln_qkv_fused(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(g), jnp.asarray(b),
        jnp.asarray(wq), jnp.asarray(sw), jnp.asarray(bias), 4, SCALE,
        interpret=True, valid_len=valid_len))
    args = _ln_qkv_port_args(x, g, b, wq, sw, bias) + (4, SCALE, valid_len)
    got = flash_attention_ln_qkv_fused_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = float(np.abs(got.float().numpy() - ref).max())
    assert err <= 2e-2 * float(np.abs(ref).max()), err
    np.testing.assert_array_equal(
        flash_attention_ln_qkv_fused(*args).float().numpy(),
        got.float().numpy())


def _wrong_inputs(kernel):
    """(call, [(bad args, error type, message)]) for one wrapper."""
    if kernel == "mlp_fused":
        a = list(_mlp_port_args(*_mlp_inputs(0, 1, 8)))
        return mlp_fused, a, [
            (1, a[1][:, :-1], ValueError, "sx"),
            (3, a[3][:, :-8], ValueError, "w1q"),
            (0, a[0].float(), TypeError, "xq must be torch.int8"),
            (2, a[2].float(), TypeError, "resid must be torch.bfloat16")]
    if kernel == "qkvp":
        a = list(_qkvp_port_args(*_qkvp_inputs(0, 1, 8))) + [4, SCALE]
        return flash_attention_qkvp_fused, a, [
            (1, a[1][:, :-1], ValueError, "row scales"),
            (5, a[5][:-8], ValueError, "wp"),
            (5, a[5].float(), TypeError, "wp must be torch.int8"),
            (8, a[8].float(), TypeError, "resid must be torch.bfloat16")]
    a = list(_ln_qkv_port_args(*_ln_qkv_inputs(0, 1, 8))) + [4, SCALE]
    return flash_attention_ln_qkv_fused, a, [
        (1, a[1][:-1], ValueError, "LayerNorm params"),
        (6, 3, ValueError, "head_dim"),
        (0, a[0].float(), TypeError, "x must be torch.bfloat16"),
        (3, a[3].float(), TypeError, "wq must be torch.int8")]


@pytest.mark.parametrize("kernel", ["mlp_fused", "qkvp", "ln_qkv"])
def test_fused_block_wrappers_check_shapes_and_dtypes(kernel):
    fn, args, cases = _wrong_inputs(kernel)
    for i, bad, err, msg in cases:
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(err, match=msg):
            fn(*wrong)


# ---- routing, one block, the ViT ----

@pytest.mark.parametrize("case", ["flashqp static", "flashqp unquantized",
                                  "mlp_fused tanh static", "mlp_fused erf"])
def test_fused_block_routes(case):
    """flashqp runs B15 only on a static-int8 model, unquantized it takes
    B6 (reference `vit.py:393`); mlp_fused runs B16 only with tanh GELU,
    with erf the plain Mlp; mlp_fused turns the B3 branch off either
    way (reference `vit.py:526-527`, `:580-596`)."""
    vit = fused_block_config(tiny_parity_config()).vit
    opts = {"flashqp static": {"mlp_fused": False},
            "flashqp unquantized": {"mlp_fused": False, "quant_int8": False},
            "mlp_fused tanh static": {"attn_impl": "flashq"},
            "mlp_fused erf": {"attn_impl": "flashq", "mlp_gelu": "exact"}}
    blk = Block(dataclasses.replace(vit, **opts[case]), torch.bfloat16)
    attn = blk.attn
    if case == "flashqp static":
        assert attn.qkvp_fused and not attn.flat and not attn.qkv_fused
    elif case == "flashqp unquantized":
        assert attn.flat and not attn.qkvp_fused
    else:
        assert not attn.qkvp_fused
        assert blk.mlp_fused == (case == "mlp_fused tanh static")
        assert not blk.ln_quant and not hasattr(blk, "act_scale")


def _random_quantized_params(params, rng, d):
    for scope, shapes in (("attn", {"qkv": (d, 3 * d), "proj": (d, d)}),
                          ("mlp", {"fc1": (d, 4 * d), "fc2": (4 * d, d)})):
        for name, (k, n) in shapes.items():
            params[scope][name] = {
                "kernel_q": rng.randint(-127, 128, (k, n)).astype(np.int8),
                "scale": (rng.rand(n) * 2e-3 / np.sqrt(k)).astype(np.float32),
                "bias": (rng.randn(n) * 0.05).astype(np.float32)}
    for norm in ("norm1", "norm2"):
        params[norm] = {"scale": (1 + 0.1 * rng.randn(d)).astype(np.float32),
                        "bias": (0.1 * rng.randn(d)).astype(np.float32)}
    return params


def test_fused_block_matches_jax():
    """One block of the fused config (LN1 -> row quantize -> B15; LN2 ->
    row quantize -> B16) against JAX's on the same random quantized
    parameters, D = 256 with 4 heads, bf16, T = 25 (which flashqp does not
    pad). The port's LayerNorm rounds once from fp32 and may move a code
    one level: the block output stays within 2e-2 of max|ref| and points
    the same way (cosine > 0.9999)."""
    from lseg_tpu.models.vit import Block as JBlock

    vit = dataclasses.replace(fused_block_config(tiny_parity_config()).vit,
                              embed_dim=256, num_heads=4)
    d = vit.embed_dim
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 25, d) * 0.5).astype(np.float32)
    jb = JBlock(d, vit.num_heads, vit.mlp_ratio, jnp.bfloat16,
                attn_impl="flashqp", quant="static", gelu=vit.mlp_gelu,
                mlp_fused=True, ln_quant_fused=True)
    params = _random_quantized_params(
        _np_tree(jb.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]),
        rng, d)
    ref = f32(jax.jit(lambda p, x: jb.apply({"params": p}, x)[0])(
        params, jnp.asarray(x, jnp.bfloat16)))
    blk = Block(vit, torch.bfloat16)
    blk.load_state_dict(from_jax_variables({"params": {"vit": {},
                                                       **params}}),
                        strict=True)
    assert blk.attn.qkvp_fused and blk.mlp_fused and not blk.ln_quant
    with torch.no_grad():
        got = blk(_t(f32(jnp.asarray(x, jnp.bfloat16))).bfloat16())
    got = got.float().numpy()
    err = float(np.abs(got - ref).max())
    cos = float((got * ref).sum() / np.linalg.norm(got) / np.linalg.norm(ref))
    print(f"fused block: max |port - jax| {err:.4g} of max|ref| "
          f"{np.abs(ref).max():.4g}, cosine {cos:.6f}")
    assert err <= 2e-2 * float(np.abs(ref).max()), err
    assert cos > 0.9999, cos


def test_fused_block_vit_taps_match_jax():
    """The fused-block DenseViT (D = 256, 4 heads) against JAX's on one
    carried-across quantized tree: the block stack compounds rounding-
    point differences, so each tap is held by direction, cosine > 0.999
    (the reference's own gate, tests/test_pallas_ops.py:369-422)."""
    from lseg_tpu.models.vit import DenseViT as JDenseViT
    from lseg_tpu.ops.quant import quantize_tree as j_quantize_tree

    base = tiny_vit_config().vit
    cfg = dataclasses.replace(base, embed_dim=256, num_heads=4,
                              attn_impl="flashqp", quant_int8="static",
                              mlp_fused=True, mlp_gelu="tanh")
    x = np.random.RandomState(0).randn(2, 64, 48, 3).astype(np.float32)
    fp32_cfg = dataclasses.replace(cfg, attn_impl="xla", quant_int8=False,
                                   mlp_fused=False)
    v0 = JDenseViT(fp32_cfg).init(jax.random.PRNGKey(0), jnp.asarray(x))
    vq = _np_tree(j_quantize_tree(v0["params"]))
    taps_j, grid_j = jax.jit(lambda p, x: JDenseViT(
        cfg, dtype=jnp.bfloat16).apply({"params": p}, x))(vq, jnp.asarray(x))
    sd = from_jax_variables({"params": {"vit": vq}})
    model = DenseViT(cfg, torch.bfloat16)
    model.load_state_dict({k[len("vit."):]: t for k, t in sd.items()},
                          strict=True)
    with torch.no_grad():
        taps, grid = model(_t(x))
    assert grid == tuple(grid_j)
    for i, (a, b) in enumerate(zip(taps, taps_j)):
        a, b = a.float().numpy().ravel(), f32(b).ravel()
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
        print(f"tap {i}: cosine {cos:.6f}")
        assert cos > 0.999, (i, cos)


# ---- the tiny fused-block LSeg model ----

def _carry(cfg, mlp_act_scale):
    """A perturbed tiny head_dim-64 tree, quantized and calibrated in JAX
    on `cfg` at the (2, 64, 96) input (T = 25), and its conversion."""
    from lseg_tpu.models.lseg import LSegNet as JNet
    from lseg_tpu.ops.quant import calibrate_act_scales as j_calibrate
    from lseg_tpu.ops.quant import quantize_tree as j_quantize_tree

    base = tiny_parity_config()
    x, txt = inputs(0, out_c=base.out_c)
    v = jax_lseg_variables(base, x, txt)
    vq = dict(v)
    vq["params"] = j_quantize_tree(v["params"], decoder=True, act_scale=True,
                                   mlp_act_scale=mlp_act_scale)
    vq = _np_tree(j_calibrate(JNet(cfg, dtype=jnp.bfloat16), vq,
                              jnp.asarray(x), None))
    return x, txt, v, cfg, vq, from_jax_variables(vq)


@pytest.fixture(scope="module")
def carried():
    return _carry(fused_block_config(tiny_parity_config()), False)


def _port(cfg, sd):
    model = LSegNet(cfg, dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True)
    return model


def _jax_apply(cfg, dtype, v, *args, **kw):
    from lseg_tpu.models.lseg import LSegNet as JNet

    return jax.jit(lambda v, *a: JNet(cfg, dtype=dtype).apply(v, *a, **kw))(
        v, *[jnp.asarray(a) for a in args])


def test_fused_block_lseg_builds_and_covers_every_leaf(carried):
    *_, cfg, vq, sd = carried
    model = _port(cfg, sd)
    blk = model.vit.blocks[0]
    assert blk.attn.qkvp_fused and blk.mlp_fused and not blk.ln_quant
    assert not hasattr(blk, "act_scale")
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(vq))
    n_port = sum(t.numel() for t in model.state_dict().values())
    assert n_port == n_jax
    assert model.state_dict()["vit.blocks.0.mlp.fc1.weight_q"].shape == (
        512, 128)


def _halfres_bound(x, txt, cfg, vq, model, what):
    ref_bf16 = f32(_jax_apply(cfg, jnp.bfloat16, vq, x, txt,
                              return_halfres=True))
    ref_fp32 = f32(_jax_apply(fp32_reference_of(cfg), jnp.float32, vq, x,
                              txt, return_halfres=True))
    with torch.no_grad():
        got = model(_t(x), _t(txt), return_halfres=True)
    assert got.dtype == torch.bfloat16 and got.shape == ref_bf16.shape
    d_port, d_ref = assert_bf16_bound(got.float().numpy(), ref_bf16,
                                      ref_fp32, what)
    print(f"{what}: d_port={d_port} d_ref={d_ref}")


def test_fused_block_halfres_logits_within_bf16_bound(carried):
    """B4's half-res logits of the port against JAX's on the same tree,
    by d_port <= 2 d_ref + 0.05, d_ref = JAX bf16 vs JAX fp32."""
    x, txt, _, cfg, vq, sd = carried
    _halfres_bound(x, txt, cfg, vq, _port(cfg, sd),
                   "fused block half-res logits")


def test_fused_block_argmax_matches_jitted_batch1(carried):
    """bench.py's call, `model(x, txt, return_argmax=True)` (the lowres B4
    head), against the jitted batch-1 JAX program, gated at the 0.985 of
    the other int8 heads (ROADMAP C: random-init near ties)."""
    x, txt, _, cfg, vq, sd = carried
    with torch.no_grad():
        got = _port(cfg, sd)(_t(x), _t(txt), return_argmax=True)
    assert got.dtype == torch.int32 and got.shape == (2, 64, 96)
    ref = np.concatenate([np.asarray(_jax_apply(
        cfg, jnp.bfloat16, vq, x[i:i + 1], txt, return_argmax=True))
        for i in range(2)])
    agree = float(np.mean(got.numpy() == ref))
    print(f"fused block labels vs JAX batch-1 program {agree:.4f}")
    assert agree >= 0.985, agree


def test_fused_block_calibration_leaves_no_vit_site(carried):
    """The port's own quantize_tree (with the MLP-hidden placeholders) +
    calibrate_act_scales on the fused config, one batch without text: the
    ViT keeps no act_scale, and the decoder/head1 sites are the
    reference's, each calibrated."""
    x, _, v, cfg, _, sd_ref = carried
    model = _port(cfg, quantize_tree(from_jax_variables(v), decoder=True,
                                     act_scale=True, mlp_act_scale=False))
    calibrate_act_scales(model, _t(x), None)
    got = model.state_dict()
    sites = sorted(k for k in sd_ref if k.endswith("act_scale"))
    assert sites and not any(k.startswith("vit.") for k in sites)
    assert sorted(k for k in got if k.endswith("act_scale")) == sites
    assert all(float(got[k]) != 1.0 for k in sites)


def test_flashqp_mlp_act_scale_follows_the_branch():
    """`flashqp` alone on fast_cal (`ln_quant_fused=True`,
    `mlp_act_cal=True`) at T = 25, which flashqp does not pad, so the
    reference's LN2 + quantize branch, the only place it declares the
    MLP-hidden act_scale, never runs: the JAX tree carries no such leaf
    and loads into the port; the port's own tree with placeholders keeps
    none after calibration; the half-res logits hold the bf16 bound."""
    base = fast_serving(tiny_parity_config(), "static_cal")
    cfg = dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, attn_impl="flashqp"))
    assert cfg.vit.ln_quant_fused and cfg.vit.mlp_act_cal
    x, txt, v, cfg, vq, sd = _carry(cfg, False)
    assert not any(k.endswith("act_scale") and k.startswith("vit.")
                   for k in sd)
    model = _port(cfg, sd)
    assert model.vit.blocks[0].ln_quant
    assert not any(k.startswith("vit.") and k.endswith("act_scale")
                   for k in model.state_dict())
    _halfres_bound(x, txt, cfg, vq, model, "flashqp half-res logits")

    own = LSegNet(cfg, dtype=torch.bfloat16)
    own.load_state_dict(quantize_tree(from_jax_variables(v), decoder=True,
                                      act_scale=True), strict=True)
    assert any(k.startswith("vit.") and k.endswith("act_scale")
               for k in own.state_dict())
    calibrate_act_scales(own, _t(x), None)
    scales = {k: float(t) for k, t in own.state_dict().items()
              if k.endswith("act_scale")}
    assert not any(k.startswith("vit.") for k in scales)
    assert scales and all(s != 1.0 for s in scales.values())


def test_profile_serving_needs_a_card(monkeypatch, capsys):
    """The profiling CLI measures the card only: without one it exits 1
    and prints no numbers."""
    from lseg_tpu_torch.engine import profile_serving

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_serving.main(["--path", "fused_block"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


# ---- the CUDA kernels against their plain versions (on the card) ----

def _on(dev, args):
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args)


def _check_kernel(fn, plain, args, rel, resid_kind):
    before = fn.launches
    got = fn(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _assert_within(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                   rel, resid_kind, fn.__name__)


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,d", [(2, 901, 1024), (2, 901, 768),
                                   (1, 70, 1024), (1, 40, 768)])
@pytest.mark.parametrize("resid_kind", ["zero", "real"])
def test_mlp_fused_kernel_matches_plain(cuda_device, resid_kind, n, t, d):
    """ViT-L/16's and ViT-B's widths; 1802, 70 and 40 rows are no
    multiple of the kernel's 64-row tile."""
    args = _on(cuda_device, _mlp_port_args(*_mlp_inputs(
        3, n, t, d, 4 * d, resid_kind)))
    _check_kernel(mlp_fused, mlp_fused_plain, args, 2e-2, resid_kind)


@pytest.mark.gpu
def test_mlp_fused_kernel_refuses_other_widths(cuda_device):
    """On the card a width outside the kernel's contract raises before any
    launch, naming the contract; the launch count stays."""
    args = _on(cuda_device, _mlp_port_args(*_mlp_inputs(3, 1, 8, 256, 768)))
    before = mlp_fused.launches
    with pytest.raises(ValueError, match="H = 4 D with D a multiple"):
        mlp_fused(*args)
    assert mlp_fused.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("resid_kind", ["zero", "real"])
def test_flash_attention_qkvp_fused_kernel_matches_plain(cuda_device,
                                                         resid_kind):
    args = _on(cuda_device, _qkvp_port_args(*_qkvp_inputs(
        3, 2, 901, 1024, resid_kind))) + (16, SCALE)
    _check_kernel(flash_attention_qkvp_fused,
                  flash_attention_qkvp_fused_plain, args, 2e-2, resid_kind)


@pytest.mark.gpu
@pytest.mark.parametrize("t,valid_len", [(130, 100), (904, 901)])
@pytest.mark.parametrize("resid_kind", ["zero", "real"])
def test_flash_attention_qkvp_fused_kernel_vit_b(cuda_device, resid_kind, t,
                                                 valid_len):
    """ViT-B's width (768, 12 heads: six pairs) at a ragged T = 130 with
    keys masked past 100 (a 128-row projection tile and a ragged 2, a
    64-row attention tile and a ragged 2), and at T = 904 with keys
    masked past 901."""
    args = _on(cuda_device, _qkvp_port_args(*_qkvp_inputs(
        4, 2, t, 768, resid_kind))) + (12, SCALE, valid_len)
    _check_kernel(flash_attention_qkvp_fused,
                  flash_attention_qkvp_fused_plain, args, 2e-2, resid_kind)


@pytest.mark.gpu
def test_flash_attention_ln_qkv_fused_kernel_matches_plain(cuda_device):
    args = _on(cuda_device, _ln_qkv_port_args(*_ln_qkv_inputs(
        3, 2, 901, 1024))) + (16, SCALE)
    _check_kernel(flash_attention_ln_qkv_fused,
                  flash_attention_ln_qkv_fused_plain, args, 2e-2, "zero")


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,d,valid_len", [(2, 130, 768, 100),
                                             (2, 904, 1024, 901)])
def test_flash_attention_ln_qkv_fused_kernel_other_shapes(cuda_device, n, t,
                                                          d, valid_len):
    """B9 on the new qkv stage at ViT-B's width with ragged keys, and at
    the padded flagship token count."""
    args = _on(cuda_device, _ln_qkv_port_args(*_ln_qkv_inputs(
        4, n, t, d))) + (d // 64, SCALE, valid_len)
    _check_kernel(flash_attention_ln_qkv_fused,
                  flash_attention_ln_qkv_fused_plain, args, 2e-2, "zero")
