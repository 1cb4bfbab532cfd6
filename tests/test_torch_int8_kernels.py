"""The plain versions of the int8 kernels B3, B2 and B4 against the JAX
package's Pallas kernels, run in interpret mode, on the same seeded
inputs; the `gpu`-marked twins hold each CUDA kernel against its plain
version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import cuda_device  # noqa: F401

from lseg_tpu.ops.pallas_attention import (
    flash_attention_ln_qkv_fused_q8 as j_ln_qkv_q8,
)
from lseg_tpu.ops.pallas_correlation import head1_correlate_fused as j_head1
from lseg_tpu.ops.pallas_ln import ln_quantize_rows as j_ln_quantize
from lseg_tpu_torch.ops.flash_attention import (
    _qkv_attention_plain,
    _qkv_plain,
    check_b2_widths,
    flash_attention_ln_qkv_fused_q8,
    flash_attention_ln_qkv_fused_q8_plain,
    qkv_int8_gemm,
)
from lseg_tpu_torch.ops.head1_correlate import (
    head1_correlate_fused,
    head1_correlate_fused_plain,
)
from lseg_tpu_torch.ops.ln_quant import (
    ln_quantize_rows,
    ln_quantize_rows_plain,
)
from lseg_tpu_torch.ops.quant import _codes, quantize_rows


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bf16(a):
    """numpy fp32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _t(_f32(j)).to(torch.bfloat16)


def _ln_inputs(seed, n=2, t=32, d=256):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, t, d).astype(np.float32) * 0.3 + 0.05
    g = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    return x, g, b


def _q8_inputs(seed, n=2, t=32, d=256):
    x, g, b = _ln_inputs(seed, n, t, d)
    rng = np.random.RandomState(seed + 100)
    wq = rng.randint(-127, 128, (d, 3 * d)).astype(np.int8)
    sw = (rng.rand(3 * d) * 0.01).astype(np.float32)
    bias = (rng.randn(3 * d) * 0.05).astype(np.float32)
    return x, g, b, wq, sw, bias


def _head1_inputs(seed, n=2, h=6, w=5, c=64, e=128, k=7):
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (n, h, w, c)).astype(np.int8)
    sx = np.float32(0.02)
    w1q = rng.randint(-127, 128, (c, e)).astype(np.int8)   # JAX (C, E)
    s1 = (rng.rand(e) * 0.01 + 1e-3).astype(np.float32)
    b1 = (rng.randn(e) * 0.1).astype(np.float32)
    txt = rng.randn(k, e).astype(np.float32)
    return xq, sx, w1q, s1, b1, txt


def _bf16_ulp(a):
    """One bf16 ulp at each |a| (2^(e-7) for a in [2^e, 2^(e+1)))."""
    m = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(m)) - 7)


# ---- B3: LayerNorm + row int8 quantize ----

def test_ln_quantize_rows_plain_matches_pallas():
    x, g, b = _ln_inputs(0)
    xj, xt = _bf16(x)
    qj, sj = j_ln_quantize(xj, jnp.asarray(g), jnp.asarray(b))
    qt, st = ln_quantize_rows_plain(xt, _t(g), _t(b))
    qj = np.asarray(qj, np.int32)
    qt = qt.numpy().astype(np.int32)
    assert qt.shape == qj.shape and st.shape == (2, 32, 1)
    # rsqrt and the mean/variance sums differ by ulps between XLA and
    # PyTorch, so a code may sit one level off at a bin edge
    assert np.abs(qt - qj).max() <= 1
    assert np.mean(qt == qj) >= 0.999
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=0)
    # the wrapper takes the plain version for a CPU tensor
    qw, sw = ln_quantize_rows(xt, _t(g), _t(b))
    np.testing.assert_array_equal(qw.numpy(), qt.astype(np.int8))
    np.testing.assert_array_equal(sw.numpy(), st.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("t", [901, 904, 37])
def test_ln_quantize_rows_kernel_matches_plain(cuda_device, t):
    x, g, b = _ln_inputs(1, n=2, t=t, d=1024)
    xt = _t(x).to(cuda_device, torch.bfloat16)
    gt, bt = _t(g).to(cuda_device), _t(b).to(cuda_device)
    q, s = ln_quantize_rows(xt, gt, bt)
    qp, sp = ln_quantize_rows_plain(xt, gt, bt)
    torch.cuda.synchronize()
    diff = (q.int() - qp.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 0).float().mean()) >= 0.999
    torch.testing.assert_close(s, sp, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [640, 768, 1024, 2048])
def test_ln_quantize_rows_kernel_widths(cuda_device, d):
    """B3 at an odd multiple of 128 (640), ViT-B's 768, ViT-L's 1024 and
    the widest, 2048, at one row and at 7209 (a partial last ring on the
    persistent warps): within chip_smoke.py's LNQ_* gate over both calls
    (codes one level apart at most, 99.9% equal, scales to 1e-5)."""
    qs, qps = [], []
    for t in (1, 7209):
        x, g, b = _ln_inputs(d + t, n=1, t=t, d=d)
        xt = _t(x).to(cuda_device, torch.bfloat16)
        gt, bt = _t(g).to(cuda_device), _t(b).to(cuda_device)
        before = ln_quantize_rows.launches
        q, s = ln_quantize_rows(xt, gt, bt)
        qp, sp = ln_quantize_rows_plain(xt, gt, bt)
        torch.cuda.synchronize()
        assert ln_quantize_rows.launches == before + 1
        torch.testing.assert_close(s, sp, rtol=1e-5, atol=0)
        qs.append(q.flatten())
        qps.append(qp.flatten())
    diff = (torch.cat(qs).int() - torch.cat(qps).int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 0).float().mean()) >= 0.999


# ---- B3's walk on the card (csrc/ln_quantize.cuh), emulated ----

def _b3_slots(d):
    return 3 if d <= 1024 else 2


def _b3_codes(xn, s, fallback=True):
    """B3's codes of rows xn (rows, D) fp32 with row scales s (rows, 1), as
    `code_bits_fast` (lseg_common.cuh) gives them: each lane's chunk of CH
    values (CH = 8, or 4 at an odd multiple of 128) takes the product with
    the rounded reciprocal 1 / s, clipped to +-127 and rounded by the
    1.5 * 2^23 bias, and the IEEE division for the whole chunk where one
    clipped product lies within 1e-4 of a half-integer; without
    `fallback`, never."""
    f32 = np.float32
    big = f32(12582912.0)
    ch = 8 if xn.shape[1] % 256 == 0 else 4
    inv = (f32(1.0) / s).astype(f32)
    t = np.fmin(np.fmax((xn * inv).astype(f32), f32(-127)), f32(127))
    r = ((t + big).astype(f32) - big).astype(f32)
    near = np.abs((t - r).astype(f32)) >= f32(0.4999)
    near = near.reshape(len(xn), -1, ch).any(-1, keepdims=True)
    near = np.broadcast_to(near, near.shape[:2] + (ch,)).reshape(xn.shape)
    div = np.clip(np.rint((xn / s).astype(f32)), -127, 127)
    return np.where(near & fallback, div, r).astype(np.int8)


def _b3_walk_emulated(x, g, b, eps=1e-6, ctas=396, skip_partial=False):
    """B3's walk and arithmetic in numpy: x (rows, D) fp32 on the bf16 grid.
    Warp gw of TW = 8 ctas takes rows gw, gw + TW, ... through its ring of
    slots; each lane sums its chunks (32 i + lane) CH in order, the warp
    joins the lanes by the xor butterfly; LayerNorm in the kernel's
    rounding steps (rsqrt to fp32 rounding); the scale s = max|xn| / 127
    by division; the codes by `_b3_codes`. Returns (codes, scales, xn)
    with unwalked rows zero; `skip_partial` walks no row of a warp's last
    ring where it is not full."""
    f32 = np.float32
    rows, d = x.shape
    ch = 8 if d % 256 == 0 else 4
    lanes = x.reshape(rows, d // (32 * ch), 32, ch)

    def warp_sum(per_value):
        acc = np.zeros((rows, 32), f32)
        for i in range(per_value.shape[1]):
            for j in range(ch):
                acc = (acc + per_value[:, i, :, j]).astype(f32)
        for o in (16, 8, 4, 2, 1):
            acc = (acc + acc[:, np.arange(32) ^ o]).astype(f32)
        assert (acc == acc[:, :1]).all()
        return acc[:, :1, None, None]

    mu = (warp_sum(lanes) / f32(d)).astype(f32)
    xc = (lanes - mu).astype(f32)
    var = (warp_sum((xc * xc).astype(f32)) / f32(d)).astype(f32)
    r = (1.0 / np.sqrt((var + f32(eps)).astype(np.float64))).astype(f32)
    xn = (((xc * r).astype(f32) * g.reshape(-1, 32, ch)).astype(f32)
          + b.reshape(-1, 32, ch)).astype(f32).reshape(rows, d)
    s = (np.maximum(np.abs(xn).max(1, keepdims=True), f32(1e-8))
         / f32(127)).astype(f32)
    q = _b3_codes(xn, s)
    tw = 8 * min(-(-rows // 8), ctas)
    ns = _b3_slots(d)
    walked = np.zeros(rows, int)
    for gw in range(min(tw, rows)):
        mine = np.arange(gw, rows, tw)
        keep = len(mine) - len(mine) % ns if skip_partial else len(mine)
        walked[mine[:keep]] += 1
    assert walked.max() <= 1
    done = walked.astype(bool)
    return np.where(done[:, None], q, 0), np.where(done[:, None], s, 0), xn


@pytest.mark.parametrize("d", [640, 768, 1024])
def test_b3_walk_emulated(d):
    """B3's persistent walk over 1, 7, 901, 7208 and 7209 rows (a card's
    396 CTAs and 2 CTAs): every row once, its codes the IEEE division's
    given xn and s bit for bit, and within chip_smoke.py's LNQ_* gate of
    the plain twin over the five calls; a walk that skips a warp's last
    partial ring differs."""
    diffs = []
    for rows in (1, 7, 901, 7208, 7209):
        x, g, b = _ln_inputs(rows + d, n=1, t=rows, d=d)
        x = _f32(jnp.asarray(x[0], jnp.bfloat16))
        for ctas in (396, 2):
            q, s, xn = _b3_walk_emulated(x, g, b, ctas=ctas)
            div = np.clip(np.rint((xn / s).astype(np.float32)), -127, 127)
            np.testing.assert_array_equal(q, div.astype(np.int8))
            qs, _, _ = _b3_walk_emulated(x, g, b, ctas=ctas,
                                         skip_partial=True)
            if rows % (8 * min(-(-rows // 8), ctas)) or rows < 8 * ctas:
                assert not np.array_equal(qs, q)
        qp, sp = ln_quantize_rows_plain(_t(x)[None].bfloat16(), _t(g), _t(b))
        np.testing.assert_allclose(s, sp[0].numpy(), rtol=1e-5, atol=0)
        diffs.append(np.abs(q.astype(int) - qp[0].numpy().astype(int))
                     .flatten())
    diff = np.concatenate(diffs)
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999


@pytest.mark.parametrize("d", [640, 1024])
def test_b3_fast_codes_are_the_division(d):
    """B3's codes of values placed a few ulps either side of every
    half-integer quotient up to the clip and past it, and of random ones,
    as `test_b5_fast_quantize_is_the_division` places them: the product
    with the reciprocal falls back to the division chunk by chunk, and the
    codes equal the division's bit for bit; without the fallback (the
    `b3_no_division` variant) they do not."""
    f32 = np.float32
    rng = np.random.RandomState(d)
    bare = False
    for s in (0.0123, 1.0 / 127.0, 3.7e-3, 0.5):
        k = np.arange(-140, 141).astype(f32) + f32(0.5)
        edge = (k * f32(s)).astype(f32)
        vals = [edge]
        for _ in range(3):
            vals.append(np.nextafter(vals[-1], np.inf).astype(f32))
            vals.insert(0, np.nextafter(vals[0], -np.inf).astype(f32))
        vals = np.concatenate(vals + [(rng.randn(20 * d) * 60 * s
                                       ).astype(f32)])
        vals = np.resize(rng.permutation(vals), (len(vals) // d + 1) * d)
        xn = vals.reshape(-1, d).astype(f32)
        sc = np.full((len(xn), 1), f32(s))
        div = np.clip(np.rint((xn / sc).astype(f32)), -127, 127)
        np.testing.assert_array_equal(_b3_codes(xn, sc), div.astype(np.int8))
        # (a power-of-two scale makes the product the quotient)
        bare |= not np.array_equal(_b3_codes(xn, sc, fallback=False),
                                   div.astype(np.int8))
    assert bare


# ---- B2: LN1 + int8 qkv + attention + int8 output ----

@pytest.mark.parametrize("valid_len", [None, 29])
def test_ln_qkv_q8_plain_matches_pallas(valid_len):
    x, g, b, wq, sw, bias = _q8_inputs(2)
    heads, scale = 4, 64 ** -0.5
    xj, xt = _bf16(x)
    oj, osj = j_ln_qkv_q8(xj, jnp.asarray(g), jnp.asarray(b),
                          jnp.asarray(wq), jnp.asarray(sw),
                          jnp.asarray(bias), heads, scale,
                          valid_len=valid_len, quad=True)
    ot, ost = flash_attention_ln_qkv_fused_q8_plain(
        xt, _t(g), _t(b), _t(wq.T), _t(sw), _t(bias), heads, scale,
        valid_len)
    assert ot.dtype == torch.int8 and ot.shape == (2, 32, 256)
    assert ost.shape == (2, 32, 1)
    ref = np.asarray(oj, np.float32) * np.asarray(osj)
    got = ot.numpy().astype(np.float32) * ost.numpy()
    # the bound of the reference's own variant check
    # (tests/test_pallas_ops.py:1001-1002)
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert err < 2e-2, err


@pytest.mark.gpu
@pytest.mark.parametrize("t,valid_len", [(901, None), (904, 901), (70, 61)])
def test_ln_qkv_q8_kernel_matches_plain(cuda_device, t, valid_len):
    x, g, b, wq, sw, bias = _q8_inputs(3, n=2, t=t, d=1024)
    dev = cuda_device
    args = (_t(x).to(dev, torch.bfloat16), _t(g).to(dev), _t(b).to(dev),
            _t(np.ascontiguousarray(wq.T)).to(dev), _t(sw).to(dev),
            _t(bias).to(dev), 16, 64 ** -0.5, valid_len)
    oq, os_ = flash_attention_ln_qkv_fused_q8(*args)
    pq, ps = flash_attention_ln_qkv_fused_q8_plain(*args)
    torch.cuda.synchronize()
    got = oq.float() * os_
    ref = pq.float() * ps
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err < 2e-2, err


def _b2_cluster_emulated(x, g, b, wq, sw, bias, num_heads, scale,
                         valid_len=None, own_amax=False):
    """Kernel B2's cluster epilogue (csrc/pair_attention.cuh, row mode) in
    torch on the CPU: the plain LN codes, qkv and bf16 attention output;
    per row each head's amax over its 64 columns, each CTA's slice amax
    the max of its pair's two heads, the row's the max of the D / 128
    slices (with `own_amax`, each CTA's own slice alone, the exchange cut
    out); each CTA's 128 code columns quantized with its scale, and rank
    0's scale written out."""
    xq, sx = ln_quantize_rows_plain(x, g, b)
    o = _qkv_attention_plain(xq, sx, wq, sw, bias, num_heads, scale,
                             valid_len).float()
    d = o.shape[-1]
    heads = [o[..., 64 * h:64 * h + 64].abs().amax(-1, keepdim=True)
             for h in range(d // 64)]
    slices = [torch.maximum(heads[2 * p], heads[2 * p + 1])
              for p in range(d // 128)]
    amax = torch.stack(slices).amax(0)
    scales = [torch.clamp(s if own_amax else amax, min=1e-8) / 127.0
              for s in slices]
    codes = torch.cat([_codes(o[..., 128 * p:128 * p + 128], scales[p])
                       for p in range(d // 128)], -1)
    return codes, scales[0]


@pytest.mark.parametrize("d", [1024, 768])
def test_b2_cluster_decomposition_emulated(d):
    """At ViT-L/16's and ViT-B's widths (clusters of 8 and 6 CTAs), 70
    tokens with keys masked past 61 and eight v channels of graded bias,
    one in each eighth of D, so that each slice has its own maximum: the
    kernel's cluster decomposition equals
    `flash_attention_ln_qkv_fused_q8_plain` bit for bit (max is exact and
    order-free); with each CTA's amax over its own slice alone it
    differs."""
    x, g, b, wq, sw, bias = _q8_inputs(8, n=1, t=70, d=d)
    bias[2 * d + d // 16::d // 8] += np.arange(1.0, 9.0,
                                               dtype=np.float32)[:8]
    args = (_t(x).bfloat16(), _t(g), _t(b), _t(np.ascontiguousarray(wq.T)),
            _t(sw), _t(bias), d // 64, 64 ** -0.5, 61)
    ref_q, ref_s = flash_attention_ln_qkv_fused_q8_plain(*args)
    q, s = _b2_cluster_emulated(*args)
    assert torch.equal(q, ref_q) and torch.equal(s, ref_s)
    q, s = _b2_cluster_emulated(*args, own_amax=True)
    assert not torch.equal(q, ref_q)


@pytest.mark.parametrize("d,ok", [(1024, True), (768, True), (128, True),
                                  (384, True), (896, True), (1152, False),
                                  (2048, False), (64, False), (320, False)])
def test_b2_kernel_widths(d, ok):
    """B2's width contract on the card (a cluster of D / 128 <= 8 CTAs,
    one a head pair): ViT-L/16's and ViT-B's widths pass, and a width
    outside it raises a ValueError that names the contract."""
    if ok:
        check_b2_widths(d)
    else:
        with pytest.raises(ValueError, match="D a multiple of 128 from 128 "
                                             "to 1024"):
            check_b2_widths(d)


def test_qkv_int8_gemm_takes_the_plain_stage_on_cpu():
    """The qkv stage's wrapper runs `_qkv_plain` for a CPU tensor, with
    (N, T, 3D) bf16 out."""
    x, g, b, wq, sw, bias = _q8_inputs(9, n=2, t=20, d=128)
    xq, sx = quantize_rows(_t(x))
    w = _t(np.ascontiguousarray(wq.T))
    got = qkv_int8_gemm(xq, sx, w, _t(sw), _t(bias))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 20, 384)
    assert torch.equal(got, _qkv_plain(xq, sx, w, _t(sw), _t(bias)))


@pytest.mark.gpu
@pytest.mark.parametrize("t,valid_len", [(130, 100), (904, 901),
                                         (901, None)])
def test_ln_qkv_q8_kernel_vit_b(cuda_device, t, valid_len):
    """ViT-B's width (768, 12 heads: a cluster of 6 CTAs) at a ragged
    T = 130 with keys masked past 100, at T = 904 with keys masked past
    901, and at 901."""
    x, g, b, wq, sw, bias = _q8_inputs(5, n=2, t=t, d=768)
    dev = cuda_device
    args = (_t(x).to(dev, torch.bfloat16), _t(g).to(dev), _t(b).to(dev),
            _t(np.ascontiguousarray(wq.T)).to(dev), _t(sw).to(dev),
            _t(bias).to(dev), 12, 64 ** -0.5, valid_len)
    before = flash_attention_ln_qkv_fused_q8.launches
    oq, os_ = flash_attention_ln_qkv_fused_q8(*args)
    pq, ps = flash_attention_ln_qkv_fused_q8_plain(*args)
    torch.cuda.synchronize()
    assert flash_attention_ln_qkv_fused_q8.launches == before + 1
    err = float((oq.float() * os_ - pq.float() * ps).abs().max()
                / (pq.float() * ps).abs().max())
    assert err < 2e-2, err


@pytest.mark.gpu
def test_ln_qkv_q8_kernel_refuses_other_widths(cuda_device):
    """On the card a width outside B2's contract (D = 1152, a cluster of 9)
    raises before any launch, naming the contract."""
    x, g, b, wq, sw, bias = _q8_inputs(6, n=1, t=8, d=1152)
    dev = cuda_device
    args = (_t(x).to(dev, torch.bfloat16), _t(g).to(dev), _t(b).to(dev),
            _t(np.ascontiguousarray(wq.T)).to(dev), _t(sw).to(dev),
            _t(bias).to(dev), 18, 64 ** -0.5)
    before = flash_attention_ln_qkv_fused_q8.launches
    with pytest.raises(ValueError, match="D a multiple of 128 from 128"):
        flash_attention_ln_qkv_fused_q8(*args)
    assert flash_attention_ln_qkv_fused_q8.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,d", [(8, 901, 1024), (2, 130, 768),
                                   (1, 70, 384)])
def test_qkv_int8_gemm_kernel_equals_plain(cuda_device, n, t, d):
    """The s8 wgmma qkv stage of B2, B8, B9 and B15 (csrc/qkv_wgmma.cuh)
    against `_qkv_plain` bit for bit: exact int32 sums and the same fp32
    rounding points; 7208, 260 and 70 rows are no multiple of its 128-row
    tile."""
    x, g, b, wq, sw, bias = _q8_inputs(7, n=n, t=t, d=d)
    dev = cuda_device
    xq, sx = quantize_rows(_t(x).to(dev))
    w = _t(np.ascontiguousarray(wq.T)).to(dev)
    got = qkv_int8_gemm(xq, sx, w, _t(sw).to(dev), _t(bias).to(dev))
    ref = _qkv_plain(xq, sx, w, _t(sw).to(dev), _t(bias).to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


# ---- B4: int8 head1 + correlation ----

@pytest.mark.parametrize("normalize", [False, True])
def test_head1_correlate_plain_matches_pallas(normalize):
    xq, sx, w1q, s1, b1, txt = _head1_inputs(4)
    scale = 1.0 / 0.07
    ref = _f32(j_head1(jnp.asarray(xq), jnp.asarray(sx),
                       jnp.asarray(w1q.reshape(1, 1, *w1q.shape)),
                       jnp.asarray(s1), jnp.asarray(b1), jnp.asarray(txt),
                       logit_scale=scale, tile_m=64, normalize=normalize))
    w_oihw = np.ascontiguousarray(w1q.T).reshape(w1q.shape[1], -1, 1, 1)
    got = head1_correlate_fused_plain(_t(xq), torch.tensor(sx), _t(w_oihw),
                                      _t(s1), _t(b1), _t(txt), scale,
                                      normalize)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    got = got.float().numpy()
    # one bf16 ulp (the fp32 sums are ordered differently) + 1e-3
    assert np.all(np.abs(got - ref) <= _bf16_ulp(ref) + 1e-3), (
        np.abs(got - ref).max())
    wrapped = head1_correlate_fused(_t(xq), torch.tensor(sx), _t(w_oihw),
                                    _t(s1), _t(b1), _t(txt), scale,
                                    normalize)
    np.testing.assert_array_equal(wrapped.float().numpy(), got)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,k,normalize", [
    ((2, 120, 120, 256), 150, False), ((1, 240, 240, 256), 150, True),
    ((1, 7, 9, 256), 21, True)])
def test_head1_correlate_kernel_matches_plain(cuda_device, shape, k,
                                             normalize):
    n, h, w, c = shape
    xq, sx, w1q, s1, b1, txt = _head1_inputs(5, n, h, w, c, 512, k)
    dev = cuda_device
    args = (_t(xq).to(dev), torch.tensor(sx, device=dev),
            _t(np.ascontiguousarray(w1q.T)).to(dev), _t(s1).to(dev),
            _t(b1).to(dev), _t(txt).to(dev), 1.0 / 0.07, normalize)
    got = head1_correlate_fused(*args).float()
    ref = head1_correlate_fused_plain(*args).float()
    torch.cuda.synchronize()
    ulp = torch.exp2(torch.floor(torch.log2(
        ref.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)
    assert bool(((got - ref).abs() <= ulp + 1e-3).all())
