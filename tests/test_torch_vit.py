"""The port's DenseViT against the JAX package's, on the same converted
weights: fp32 parity (XLA attention and flat flash attention) and the
bf16 fast config (patch kernel + flat flash kernel, tanh GELU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    assert_bf16_bound,
    f32,
    inputs,
    jax_lseg_variables,
    tiny_fast_config,
    tiny_parity_config,
)

from lseg_tpu.models.vit import DenseViT as JViT
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.models.vit import Attention, DenseViT
from lseg_tpu_torch.utils.convert import from_jax_variables


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_parity_config()
    x, txt = inputs(0, out_c=cfg.out_c)
    v = jax_lseg_variables(cfg, x, txt)
    return x, v, from_jax_variables(v)


def _jax_taps(vit_cfg, dtype, v, x):
    taps, grid = jax.jit(
        lambda p, x: JViT(vit_cfg, dtype=dtype).apply({"params": p}, x)
    )(v["params"]["vit"], jnp.asarray(x))
    return [f32(t) for t in taps], grid


def _port_taps(cfg, dtype, sd, x):
    model = LSegNet(cfg, dtype=dtype)
    model.load_state_dict(sd)
    with torch.no_grad():
        taps, grid = model.vit(torch.from_numpy(x))
    return [t.float().numpy() for t in taps], grid


@pytest.mark.parametrize("cfg_fn", [tiny_parity_config, tiny_fast_config],
                         ids=["xla_attention", "flashflat"])
def test_densevit_fp32_taps_match(setup, cfg_fn):
    """fp32 on both sides; the fast config's JAX side pads T to a
    multiple of 8 and masks by valid_len, the port does not pad."""
    x, v, sd = setup
    cfg = cfg_fn()
    ref, rgrid = _jax_taps(cfg.vit, jnp.float32, v, x)
    got, grid = _port_taps(cfg, torch.float32, sd, x)
    assert grid == rgrid == (4, 6)
    for r, g in zip(ref, got):
        assert g.shape == r.shape == (2, 25, 128)
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)


def test_densevit_bf16_fast_taps_within_bound(setup):
    x, v, sd = setup
    cfg = tiny_fast_config()
    ref_bf16, _ = _jax_taps(cfg.vit, jnp.bfloat16, v, x)
    ref_fp32, _ = _jax_taps(cfg.vit, jnp.float32, v, x)
    got, _ = _port_taps(cfg, torch.bfloat16, sd, x)
    for i, (g, rb, rf) in enumerate(zip(got, ref_bf16, ref_fp32)):
        d_port, d_ref = assert_bf16_bound(g, rb, rf, f"tap {i}")
        print(f"tap {i}: d_port={d_port} d_ref={d_ref}")


def test_attention_flashflat_equals_xla_impl_fp32():
    """The two Attention impls of the port compute the same function."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 21, 128).astype(np.float32))
    a = Attention(128, 2, impl="xla")
    torch.manual_seed(0)
    for p in a.parameters():
        p.normal_(0, 0.1)
    b = Attention(128, 2, impl="flashflat")
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(b(x), a(x), rtol=1e-5, atol=1e-5)


def test_densevit_rejects_unported_layout(setup):
    """The layout the port once refused: `tp_layout=True` (the JAX
    package's head-major tensor-parallel layout) builds, reads the
    head-major tree of `to_tp_layout` (`from_jax_variables` reshapes it),
    and its taps match JAX's `tp_layout` ViT on one process in fp32: the
    reference's head-major branch, einsum attention without the flat
    kernels or the token padding."""
    import dataclasses

    from lseg_tpu.utils.checkpoint_convert import to_tp_layout

    x, v, _ = setup
    cfg = tiny_parity_config()
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, attn_impl="flashflat", tp_layout=True))
    vit = DenseViT(cfg.vit)
    assert not any(b.attn.flat for b in vit.blocks)
    vtp = {"params": to_tp_layout(v["params"], cfg.vit.num_heads),
           "batch_stats": v["batch_stats"]}
    assert vtp["params"]["vit"]["seg0"]["blocks"]["attn"]["qkv"][
        "kernel"].ndim == 5
    ref, rgrid = _jax_taps(cfg.vit, jnp.float32, vtp, x)
    got, grid = _port_taps(cfg, torch.float32, from_jax_variables(vtp), x)
    assert grid == rgrid == (4, 6)
    for r, g in zip(ref, got):
        assert g.shape == r.shape == (2, 25, 128)
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)
