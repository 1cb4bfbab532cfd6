"""The port's ops against the JAX package's: resize, correlation, and the
plain versions of the two kernels against the Pallas kernels run in
interpret mode. Kernel-vs-plain checks on the card are marked `gpu`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import cuda_device  # noqa: F401

from lseg_tpu.ops import correlation as jcorr
from lseg_tpu.ops import resize as jresize
from lseg_tpu.ops.pallas_attention import flash_attention_flat as j_flash
from lseg_tpu.ops.pallas_patch import patch_embed_fused as j_patch
from lseg_tpu_torch.ops import correlation as tcorr
from lseg_tpu_torch.ops import resize as tresize
from lseg_tpu_torch.ops.flash_attention import (
    flash_attention_flat,
    flash_attention_flat_plain,
)
from lseg_tpu_torch.ops.patch_embed import patch_embed, patch_embed_plain


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("align_corners,dtype,shape,out", [
    (True, "float32", (2, 6, 7, 5), (12, 14)),       # x2 decoder/head
    (False, "float32", (1, 4, 4, 8), (5, 7)),        # pos-embed grid
    (True, "bfloat16", (2, 6, 7, 5), (12, 14)),      # fast bf16 head
])
def test_resize_matches_reference(align_corners, dtype, shape, out):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    ref = jresize.resize_bilinear(jnp.asarray(x), *out, align_corners,
                                  compute_dtype=jd)
    got = tresize.resize_bilinear(_t(x), *out, align_corners,
                                  compute_dtype=td)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)
    if align_corners:
        up = tresize.upsample2x(_t(x), compute_dtype=td)
        np.testing.assert_array_equal(up.numpy(), got.numpy())


@pytest.mark.parametrize("dtype,defer", [
    ("float32", False), ("bfloat16", False), ("bfloat16", True)])
def test_correlate_matches_reference(dtype, defer):
    rng = np.random.RandomState(1)
    img = rng.randn(2, 5, 6, 64).astype(np.float32)
    txt = rng.randn(7, 64).astype(np.float32)
    ref = jcorr.correlate(jnp.asarray(img), jnp.asarray(txt),
                          compute_dtype=getattr(jnp, dtype),
                          defer_pixel_norm=defer)
    got = tcorr.correlate(_t(img), _t(txt),
                          compute_dtype=getattr(torch, dtype),
                          defer_pixel_norm=defer)
    assert got.dtype == getattr(torch, dtype)
    # bf16: one output ulp at |logit| <= 1/0.07
    tol = 1e-5 if dtype == "float32" else 0.0625
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("shape,dim", [((2, 64, 96, 3), 128),
                                       ((1, 32, 48, 3), 64)])
def test_patch_embed_plain_matches_pallas(shape, dim):
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(16, 16, 3, dim) * 0.05).astype(np.float32)
    b = rng.randn(dim).astype(np.float32)
    ref = j_patch(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), 16, dim,
                  interpret=True)
    got = patch_embed_plain(_t(x), _t(k.reshape(-1, dim)), _t(b), 16)
    assert got.dtype == torch.bfloat16
    assert got.shape == ref.shape
    # both round operands to bf16 and sum in fp32; the order of the sum
    # differs, so allow one bf16 ulp of the output
    r = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), r, rtol=2 ** -8,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["ragged", "valid_len", "bf16"])
def test_flash_attention_flat_plain_matches_pallas(case):
    rng = np.random.RandomState(3)
    n, h, hd = 2, 4, 64
    d = h * hd
    t, valid_len = (37, None) if case != "valid_len" else (32, 29)
    qkv = rng.randn(n, t, 3 * d).astype(np.float32)
    scale = hd ** -0.5
    jq = jnp.asarray(qkv)
    tq = _t(qkv)
    if case == "bf16":
        jq = jq.astype(jnp.bfloat16)
        tq = tq.to(torch.bfloat16)
    ref = j_flash(jq, h, scale, block_q=16, interpret=True,
                  valid_len=valid_len)
    got = flash_attention_flat_plain(tq, h, scale, valid_len)
    assert got.dtype == tq.dtype and got.shape == (n, t, d)
    r = np.asarray(ref.astype(jnp.float32))
    if case == "bf16":
        # same rounding points; summation order differs: 1 bf16 ulp
        np.testing.assert_allclose(got.float().numpy(), r, rtol=2 ** -7,
                                   atol=1e-3)
    else:
        np.testing.assert_allclose(got.numpy(), r, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t,valid_len", [(97, None), (130, 100), (37, None)],
                         ids=["ragged", "valid_len", "short"])
def test_flash_attention_flat_plain_lse(t, valid_len):
    """`return_lse=True`: the lse against a float64 logsumexp of the scaled,
    masked scores (both fp32 sums of <= T terms, so 1e-5), and the output
    against JAX's `flash_attention_flat` in interpret mode (the bound of
    the fp32 case above). A ragged T (97: one full tile and 33 rows), keys
    masked past valid_len, and T below one 64-row tile."""
    rng = np.random.RandomState(5)
    n, h, hd = 2, 4, 64
    d = h * hd
    qkv = rng.randn(n, t, 3 * d).astype(np.float32)
    scale = hd ** -0.5
    out, lse = flash_attention_flat_plain(_t(qkv), h, scale, valid_len,
                                          return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (n, h, t)
    vl = t if valid_len is None else valid_len
    r = qkv.astype(np.float64).reshape(n, t, 3, h, hd)
    s = np.einsum("nqhd,nkhd->nhqk", r[:, :, 0], r[:, :, 1]) * scale
    s = s[..., :vl]
    m = s.max(-1, keepdims=True)
    ref_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-5, atol=1e-5)
    ref = j_flash(jnp.asarray(qkv), h, scale, block_q=16, interpret=True,
                  valid_len=valid_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_wrappers_run_plain_on_cpu_and_count_no_launch():
    rng = np.random.RandomState(4)
    x = _t(rng.randn(1, 32, 32, 3).astype(np.float32))
    w = _t(rng.randn(768, 64).astype(np.float32)).to(torch.bfloat16)
    b = _t(rng.randn(64).astype(np.float32))
    qkv = _t(rng.randn(1, 5, 384).astype(np.float32)).to(torch.bfloat16)
    n0 = (patch_embed.launches, flash_attention_flat.launches)
    torch.testing.assert_close(patch_embed(x, w, b, 16),
                               patch_embed_plain(x, w, b, 16), rtol=0,
                               atol=0)
    torch.testing.assert_close(flash_attention_flat(qkv, 2, 0.125),
                               flash_attention_flat_plain(qkv, 2, 0.125),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        flash_attention_flat(qkv, 2, 0.125, return_lse=True),
        flash_attention_flat_plain(qkv, 2, 0.125, return_lse=True), rtol=0,
        atol=0)
    assert (patch_embed.launches, flash_attention_flat.launches) == n0


def test_wrappers_reject_bad_input():
    qkv = torch.zeros(1, 5, 3 * 96)
    with pytest.raises(ValueError, match="head_dim 64"):
        flash_attention_flat(qkv, 3, 0.125)
    with pytest.raises(ValueError, match="even head count"):
        flash_attention_flat(torch.zeros(1, 5, 3 * 192), 3, 0.125)
    with pytest.raises(ValueError, match="valid_len"):
        flash_attention_flat(torch.zeros(1, 5, 384), 2, 0.125, 6)
    # no silent fallback off the CPU: another device raises
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_flat(torch.zeros(1, 5, 384, device="meta"), 2, 0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        patch_embed(torch.zeros(1, 16, 16, 3, device="meta"),
                    torch.zeros(768, 64, device="meta"),
                    torch.zeros(64, device="meta"), 16)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 480, 480, 3), (1, 384, 480, 3)])
def test_patch_embed_kernel_matches_plain_on_gpu(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, device=cuda_device, generator=g)
    w = (0.05 * torch.randn(768, 1024, device=cuda_device, generator=g)
         ).to(torch.bfloat16)
    b = torch.randn(1024, device=cuda_device, generator=g)
    got = patch_embed(x, w, b, 16)
    ref = patch_embed_plain(x, w, b, 16)
    # one bf16 ulp, plus the fp32 reordering error where the sum cancels
    torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -7,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("t,valid_len", [(901, None), (904, 901),
                                         (721, None), (37, None)])
def test_flash_kernel_matches_plain_on_gpu(cuda_device, t, valid_len):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(2, t, 3 * 1024, device=cuda_device, generator=g
                      ).to(torch.bfloat16)
    got = flash_attention_flat(qkv, 16, 0.125, valid_len)
    ref = flash_attention_flat_plain(qkv, 16, 0.125, valid_len)
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("t,valid_len", [(901, None), (904, 901),
                                         (721, None), (37, None)])
def test_flash_kernel_lse_matches_plain_on_gpu(cuda_device, t, valid_len):
    """B6's lse output against the plain lse: fp32 sums of <= 904 terms
    taken in another order, and exp2 of an FMA against exp, so 1e-4
    absolute; the output keeps its 2e-2 bound."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    qkv = torch.randn(2, t, 3 * 1024, device=cuda_device, generator=g
                      ).to(torch.bfloat16)
    out, lse = flash_attention_flat(qkv, 16, 0.125, valid_len,
                                    return_lse=True)
    ref_out, ref_lse = flash_attention_flat_plain(qkv, 16, 0.125, valid_len,
                                                  return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 16, t)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
