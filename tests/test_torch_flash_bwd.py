"""Kernel B7 (the backward of flat flash attention) and the gradient path
through it: the plain twin against the Pallas backward in interpret mode,
the autograd.Function against autograd of plain softmax attention, the
port's ViT gradients against `jax.grad` of the JAX `DenseViT` with
`attn_impl='flashflat'`, and (on a card) the kernel against its plain
twin."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import cuda_device, f32  # noqa: F401

from lseg_tpu.ops.pallas_attention import _flash_flat_bwd_impl
from lseg_tpu.testing import tiny_vit_config
from lseg_tpu_torch.models.vit import DenseViT
from lseg_tpu_torch.ops.flash_attention import (
    flash_attention_flat,
    flash_attention_flat_bwd,
    flash_attention_flat_bwd_plain,
    flash_attention_flat_fn,
    flash_attention_flat_plain,
)
from lseg_tpu_torch.utils.convert import from_jax_variables

SCALE = 64 ** -0.5


def _inputs(seed, n=2, t=40, heads=2):
    rng = np.random.RandomState(seed)
    d = heads * 64
    qkv = rng.randn(n, t, 3 * d).astype(np.float32)
    do = rng.randn(n, t, d).astype(np.float32)
    return qkv, do


@pytest.mark.parametrize("valid_len", [None, 33], ids=["full", "vl33"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_matches_pallas_interpret(dtype, valid_len):
    """Same (qkv, O, dO) into the Pallas backward (interpret mode) and the
    plain twin. fp32: both are the same fp32 function summed in another
    order. bf16: the same rounding points, but pn and ds round to bf16
    and a sum taken in another order can flip one rounding; 2e-2 of
    max|ref| is the reference's own bound for its kernels."""
    qkv, do = _inputs(0)
    tdt = getattr(torch, dtype)
    q_t = torch.from_numpy(qkv).to(tdt)
    d_t = torch.from_numpy(do).to(tdt)
    with torch.no_grad():
        o_t = flash_attention_flat_plain(q_t, 2, SCALE, valid_len)
    got = f32(flash_attention_flat_bwd_plain(q_t, o_t, d_t, 2, SCALE,
                                             valid_len).float())
    jdt = jnp.dtype(dtype)
    ref = f32(_flash_flat_bwd_impl(
        jnp.asarray(f32(q_t.float()), jdt), jnp.asarray(f32(o_t.float()), jdt),
        jnp.asarray(f32(d_t.float()), jdt), 2, SCALE, valid_len, True))
    assert got.shape == ref.shape == (2, 40, 384)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        for name, sl in (("dq", slice(0, 128)), ("dk", slice(128, 256)),
                         ("dv", slice(256, 384))):
            err = np.abs(got[..., sl] - ref[..., sl]).max()
            bound = 2e-2 * np.abs(ref[..., sl]).max()
            assert err <= bound, f"{name}: {err} > {bound}"
    if valid_len is not None:  # masked keys carry no gradient
        assert not got[:, valid_len:, 128:].any()


def _softmax_attention(qkv, heads, valid_len):
    n, t, _ = qkv.shape
    q, k, v = qkv.reshape(n, t, 3, heads, 64).unbind(2)
    s = torch.einsum("nqhd,nkhd->nhqk", q, k) * SCALE
    s = s.masked_fill(torch.arange(t) >= valid_len, float("-inf"))
    return torch.einsum("nhqk,nkhd->nqhd", s.softmax(-1), v).reshape(
        n, t, heads * 64)


@pytest.mark.parametrize("valid_len", [40, 33])
def test_function_grad_matches_autograd(valid_len):
    """fp32 through `flash_attention_flat_fn` against autograd of softmax
    attention in fp64."""
    qkv, do = _inputs(1)
    x = torch.from_numpy(qkv).requires_grad_()
    out = flash_attention_flat_fn(x, 2, SCALE, valid_len)
    out.backward(torch.from_numpy(do))
    x64 = torch.from_numpy(qkv).double().requires_grad_()
    ref = _softmax_attention(x64, 2, valid_len)
    ref.backward(torch.from_numpy(do).double())
    torch.testing.assert_close(out.double(), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(x.grad.double(), x64.grad, rtol=1e-5,
                               atol=1e-5)


def test_raw_calls_refuse_tensors_that_require_grad():
    """The wrappers and plain versions have no autograd: a tensor that
    requires grad must not go through them with its gradient cut."""
    qkv = torch.randn(1, 8, 384, requires_grad=True)
    for fn in (flash_attention_flat, flash_attention_flat_plain):
        with pytest.raises(RuntimeError, match="requires grad"):
            fn(qkv, 2, SCALE)
    o = torch.randn(1, 8, 128)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_attention_flat_bwd(qkv, o, o, 2, SCALE)
    with torch.no_grad():
        assert flash_attention_flat(qkv, 2, SCALE).shape == (1, 8, 128)


@pytest.fixture(scope="module")
def vit_grads():
    """jax.grad of the JAX flashflat DenseViT (Pallas backward in
    interpret mode) at tiny_vit_config with embed 128 and 2 heads, the
    shapes of tests/test_pallas_ops.py's flashflat VJP test."""
    from lseg_tpu.models.vit import DenseViT as JViT

    base = tiny_vit_config()
    cfg = dataclasses.replace(base.vit, embed_dim=128, num_heads=2,
                              attn_impl="flashflat")
    rng = np.random.RandomState(0)
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    model = JViT(cfg)
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def loss(params):
        taps, _ = model.apply({"params": params}, jnp.asarray(x))
        return sum(jnp.sum(t * t) for t in taps) * 1e-3

    g = jax.jit(jax.grad(loss))(v["params"])
    def port(tree):
        sd = from_jax_variables({"params": {"vit": tree}})
        return {k[len("vit."):]: t for k, t in sd.items()}

    return cfg, x, port(v["params"]), port(g)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_vit_grads_match_jax_flashflat(vit_grads, remat):
    """The port's fp32 flashflat DenseViT (unpadded T, gradient through
    `FlashAttentionFlat`) against jax.grad of the padded JAX one, with the
    tolerance of the reference's own flashflat-vs-XLA gradient check."""
    cfg, x, params, grads = vit_grads
    vit = DenseViT(cfg, torch.float32, remat=remat)
    vit.load_state_dict(params)
    for p in vit.parameters():
        p.requires_grad_(True)
    taps, _ = vit(torch.from_numpy(x))
    (sum((t * t).sum() for t in taps) * 1e-3).backward()
    got = dict(vit.named_parameters())
    assert set(got) == set(grads)
    for name, ref in grads.items():
        np.testing.assert_allclose(got[name].grad.numpy(), ref.numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,heads,valid_len",
                         [(2, 40, 2, None), (2, 130, 4, 100),
                          (1, 901, 16, None)])
def test_bwd_kernel_matches_plain_on_card(cuda_device, n, t, heads,
                                          valid_len):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    d = heads * 64
    qkv = torch.randn(n, t, 3 * d, device=cuda_device, generator=g).to(
        torch.bfloat16)
    do = torch.randn(n, t, d, device=cuda_device, generator=g).to(
        torch.bfloat16)
    o = flash_attention_flat(qkv, heads, SCALE, valid_len)
    got = flash_attention_flat_bwd(qkv, o, do, heads, SCALE, valid_len)
    ref = flash_attention_flat_bwd_plain(qkv, o, do, heads, SCALE, valid_len)
    torch.cuda.synchronize()
    for sl in (slice(0, d), slice(d, 2 * d), slice(2 * d, 3 * d)):
        err = (got[..., sl].float() - ref[..., sl].float()).abs().max()
        assert err <= 2e-2 * ref[..., sl].float().abs().max()


@pytest.mark.gpu
def test_function_kernel_grads_match_plain_on_card(cuda_device):
    """The autograd.Function on the card: forward B6 and backward B7 are
    each launched once, and the gradient agrees with the plain path's."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(2, 197, 3 * 256, device=cuda_device, generator=g).to(
        torch.bfloat16)
    do = torch.randn(2, 197, 256, device=cuda_device, generator=g).to(
        torch.bfloat16)
    grads = []
    for plain in (False, True):
        x = qkv.clone().requires_grad_()
        f0 = flash_attention_flat.launches
        b0 = flash_attention_flat_bwd.launches
        flash_attention_flat_fn(x, 4, SCALE, plain=plain).backward(do)
        launched = (flash_attention_flat.launches - f0,
                    flash_attention_flat_bwd.launches - b0)
        assert launched == ((0, 0) if plain else (1, 1))
        grads.append(x.grad.float())
    torch.cuda.synchronize()
    err = (grads[0] - grads[1]).abs().max()
    assert err <= 2e-2 * grads[1].abs().max()
