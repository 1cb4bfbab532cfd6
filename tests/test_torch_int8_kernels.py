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
    flash_attention_ln_qkv_fused_q8,
    flash_attention_ln_qkv_fused_q8_plain,
)
from lseg_tpu_torch.ops.head1_correlate import (
    head1_correlate_fused,
    head1_correlate_fused_plain,
)
from lseg_tpu_torch.ops.ln_quant import (
    ln_quantize_rows,
    ln_quantize_rows_plain,
)


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
