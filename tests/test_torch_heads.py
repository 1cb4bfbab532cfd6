"""The streamed serving heads against the JAX package: the plain twins of
kernels B10 (`fused_correlate`), B11 (`upsample2x_argmax`) and B5
(`head1_correlate_argmax_fused`) against the Pallas kernels in interpret
mode, on the same seeded inputs; the port's `make_predictor(...,
use_pallas=True)` and its `head_fused=True` argmax model against the JAX
programs; and the `gpu`-marked twins that hold each CUDA kernel against
its plain version on the card. The flax models of the JAX package are
imported inside the tests that use them: the card machine has JAX but no
flax."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    cuda_device,
    f32,
    inputs,
    jax_lseg_variables,
    tiny_parity_config,
)

from lseg_tpu.config import fast_serving
from lseg_tpu.ops.pallas_correlation import (
    fused_correlate as j_fused_correlate,
)
from lseg_tpu.ops.pallas_correlation import (
    head1_correlate_argmax_fused as j_b12,
)
from lseg_tpu.ops.pallas_correlation import (
    head1_correlate_argmax_fused_t as j_b5,
)
from lseg_tpu.ops.pallas_upsample_argmax import (
    upsample2x_argmax as j_up_argmax,
)
from lseg_tpu.ops.pallas_upsample_argmax import (
    upsample2x_argmax_v2 as j_up_argmax_v2,
)
from lseg_tpu.testing import tiny_vit_config
from lseg_tpu_torch.engine.serve import make_predictor
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.ops.fused_correlate import (
    fused_correlate,
    fused_correlate_plain,
)
from lseg_tpu_torch.ops.head1_correlate import (
    head1_correlate_argmax_fused,
    head1_correlate_argmax_fused_plain,
)
from lseg_tpu_torch.ops.upsample_argmax import (
    upsample2x_argmax,
    upsample2x_argmax_plain,
)
from lseg_tpu_torch.utils.convert import from_jax_variables

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(a, dt):
    """numpy fp32 -> (jax, torch) arrays of `dt` holding the same values."""
    jdt, tdt = DTYPES[dt]
    j = jnp.asarray(a).astype(jdt)
    return j, _t(f32(j)).to(tdt)


# ---- B10: fused L2 normalisation + correlation ----

@pytest.mark.parametrize("dt,tol", [("fp32", 1e-5), ("bf16", 2e-2)])
def test_fused_correlate_plain_matches_pallas(dt, tol):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 12, 64).astype(np.float32)
    txt = rng.randn(5, 64).astype(np.float32)
    txt[2] = 0.0  # a zero label row: logits 0
    xj, xt = _pair(x, dt)
    ref = f32(j_fused_correlate(xj, jnp.asarray(txt), tile_m=64,
                                interpret=True))
    got = fused_correlate_plain(xt, _t(txt))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
    assert not got[..., 2].any()
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(fused_correlate(xt, _t(txt)).numpy(),
                                  got.numpy())


def test_fused_correlate_bf16_compute_matches_pallas():
    rng = np.random.RandomState(1)
    x = rng.randn(1, 8, 8, 64).astype(np.float32)
    txt = rng.randn(3, 64).astype(np.float32)
    ref = f32(j_fused_correlate(jnp.asarray(x), jnp.asarray(txt), tile_m=64,
                                interpret=True, compute_dtype=jnp.bfloat16))
    got = fused_correlate_plain(_t(x), _t(txt),
                                compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # the same bf16 operands, fp32 sums in another order: one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-6)


# ---- B11: x2 upsample + argmax ----

@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_upsample2x_argmax_plain_matches_pallas(version, dt):
    rng = np.random.RandomState(2)
    # H not a multiple of the tile, K not a multiple of 128
    lj, lt = _pair(rng.randn(2, 12, 16, 7).astype(np.float32), dt)
    fn = j_up_argmax if version == "v1" else j_up_argmax_v2
    ref = np.asarray(fn(lj, tile_o=8, interpret=True))
    got = upsample2x_argmax_plain(lt)
    assert got.dtype == torch.int32 and got.shape == ref.shape == (2, 24, 32)
    # fp32: the TPU kernel's interp matmuls may fuse a multiply-add where
    # the port rounds each step; bf16 products are exact in fp32 and the
    # two agree everywhere
    agree = float(np.mean(got.numpy() == ref))
    assert agree >= (0.999 if dt == "fp32" else 1.0), agree
    np.testing.assert_array_equal(upsample2x_argmax(lt).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_upsample2x_argmax_k_padding_masked(dt):
    """All-negative logits: K padding that leaked into the argmax would
    win; the labels must match the TPU kernel's exactly."""
    lj, lt = _pair(-np.ones((1, 8, 8, 3), np.float32)
                   * np.float32([3.0, 1.0, 2.0]), dt)
    got = upsample2x_argmax_plain(lt).numpy()
    np.testing.assert_array_equal(got, 1)
    np.testing.assert_array_equal(
        got, np.asarray(j_up_argmax(lj, tile_o=8, interpret=True)))
    rng = np.random.RandomState(3)
    lj, lt = _pair(-(rng.rand(1, 6, 10, 9).astype(np.float32) + 0.5), dt)
    np.testing.assert_array_equal(
        upsample2x_argmax_plain(lt).numpy(),
        np.asarray(j_up_argmax_v2(lj, tile_o=8, interpret=True)))


def test_upsample2x_argmax_plain_ties_and_edges():
    """First occurrence on ties; one-row and one-column inputs."""
    x = torch.zeros(1, 3, 4, 5)
    x[..., 1] = x[..., 3] = 1.0
    assert bool((upsample2x_argmax_plain(x) == 1).all())
    for shape in ((1, 1, 6, 4), (2, 5, 1, 4)):
        lt = torch.from_numpy(np.random.RandomState(4).randn(*shape)
                              .astype(np.float32))
        lj = jnp.asarray(lt.numpy())
        got = upsample2x_argmax_plain(lt)
        assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2])
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j_up_argmax(lj, tile_o=8,
                                                interpret=True)))


# ---- B5 / B12: int8 head1 + correlation + argmax ----

def _head1_inputs(seed, n=2, h=6, w=5, c=64, e=128, k=7):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h, w, c) * 0.7).astype(np.float32)
    sx = np.float32(np.abs(x).max() / 127.0)
    w1q = rng.randint(-127, 128, (c, e)).astype(np.int8)   # JAX (C, E)
    s1 = (rng.rand(e) * 0.01 + 1e-3).astype(np.float32)
    b1 = (rng.randn(e) * 0.1).astype(np.float32)
    txt = rng.randn(k, e).astype(np.float32)
    return x, sx, w1q, s1, b1, txt


@pytest.mark.parametrize("kernel,dt", [("t", "int8"), ("t", "bf16"),
                                       ("row", "int8")])
def test_head1_correlate_argmax_plain_matches_pallas(kernel, dt):
    x, sx, w1q, s1, b1, txt = _head1_inputs(5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xq = jnp.clip(jnp.round(xb.astype(jnp.float32) / sx), -127, 127
                  ).astype(jnp.int8)
    xj = xq if dt == "int8" else xb
    fn = j_b5 if kernel == "t" else j_b12
    ref = np.asarray(fn(xj, jnp.asarray(sx),
                        jnp.asarray(w1q.reshape(1, 1, *w1q.shape)),
                        jnp.asarray(s1), jnp.asarray(b1), jnp.asarray(txt),
                        tile_m=64))
    xt = _t(np.asarray(xq)) if dt == "int8" else _t(f32(xb)).bfloat16()
    w_oihw = _t(np.ascontiguousarray(w1q.T)).reshape(w1q.shape[1], -1, 1, 1)
    args = (xt, torch.tensor(sx), w_oihw, _t(s1), _t(b1), _t(txt))
    got = head1_correlate_argmax_fused_plain(*args)
    assert got.dtype == torch.int32 and got.shape == ref.shape == (2, 6, 5)
    # the same bf16 operands, fp32 sums in another order: a label may flip
    # only where two logits tie to fp32 rounding
    agree = float(np.mean(got.numpy() == ref))
    assert agree >= 0.999, agree
    np.testing.assert_array_equal(head1_correlate_argmax_fused(*args).numpy(),
                                  got.numpy())


def test_head1_correlate_argmax_bf16_input_is_quantize_first():
    x, sx, w1q, s1, b1, txt = _head1_inputs(6, k=9)
    xb = _t(x).bfloat16()
    xq = torch.clamp(torch.round(xb.float() / float(sx)), -127, 127
                     ).to(torch.int8)
    w_oihw = _t(np.ascontiguousarray(w1q.T)).reshape(w1q.shape[1], -1, 1, 1)
    rest = (torch.tensor(sx), w_oihw, _t(s1), _t(b1), _t(txt))
    np.testing.assert_array_equal(
        head1_correlate_argmax_fused_plain(xb, *rest).numpy(),
        head1_correlate_argmax_fused_plain(xq, *rest).numpy())


# ---- the serving entry points ----

def test_make_predictor_use_pallas_matches_jax():
    """The streamed head (B10 + B11 twins) on one carried-across
    tiny_vit_config tree, against JAX's make_predictor(use_pallas=True) in
    interpret mode; and against the port's own default head."""
    from lseg_tpu.engine.serve import make_predictor as j_make_predictor
    from lseg_tpu.models.lseg import LSegNet as JNet

    cfg = tiny_vit_config()
    x, txt = inputs(0, n=2, h=64, w=64, k=5, out_c=cfg.out_c)
    v = jax_lseg_variables(cfg, x, txt)
    ref = np.asarray(j_make_predictor(JNet(cfg), v, use_pallas=True,
                                      interpret=True)(jnp.asarray(x),
                                                      jnp.asarray(txt)))
    model = LSegNet(cfg)
    got = make_predictor(model, from_jax_variables(v), use_pallas=True)(
        x, txt)
    assert got.dtype == torch.int32 and got.shape == ref.shape == (2, 64, 64)
    agree = float(np.mean(got.numpy() == ref))
    default = float(np.mean(got.numpy() == make_predictor(model)(
        x, txt).numpy()))
    print(f"use_pallas labels vs JAX {agree:.4f}, vs the default head "
          f"{default:.4f}")
    assert agree >= 0.999, agree


@pytest.fixture(scope="module")
def head_fused_tree():
    """A perturbed tiny head_dim-64 tree quantized and calibrated in JAX
    (static_cal), with `head_fused=True`, and its conversion."""
    from lseg_tpu.models.lseg import LSegNet as JNet
    from lseg_tpu.ops.quant import calibrate_act_scales as j_calibrate
    from lseg_tpu.ops.quant import quantize_tree as j_quantize_tree

    base = tiny_parity_config()
    x, txt = inputs(0, out_c=base.out_c)
    v = jax_lseg_variables(base, x, txt)
    cfg = fast_serving(base, "static_cal")
    vq = dict(v)
    vq["params"] = j_quantize_tree(v["params"], decoder=True, act_scale=True,
                                   mlp_act_scale=bool(cfg.vit.mlp_act_cal))
    vq = j_calibrate(JNet(cfg, dtype=jnp.bfloat16), vq, jnp.asarray(x), None)
    vq = jax.tree_util.tree_map(np.asarray, vq)
    cfg = dataclasses.replace(cfg, head_fused=True)
    return x, txt, cfg, vq, from_jax_variables(vq)


def test_head_fused_argmax_matches_jitted_batch1(head_fused_tree):
    """`head_fused=True` in argmax mode runs B5 (its plain twin here)
    against the jitted batch-1 JAX program, which runs the Pallas B5 in
    interpret mode. Random-init margins are near ties that the int8 grids
    amplify, so the gate is 0.985, as for the lowres head
    (test_torch_lseg_int8.py)."""
    from lseg_tpu.models.lseg import LSegNet as JNet

    x, txt, cfg, vq, sd = head_fused_tree
    model = LSegNet(cfg, dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        full = model(torch.from_numpy(x), torch.from_numpy(txt),
                     return_argmax=True)
        half = model(torch.from_numpy(x), torch.from_numpy(txt),
                     return_argmax=True, return_halfres=True)
    assert full.dtype == torch.int32 and full.shape == (2, 64, 96)
    np.testing.assert_array_equal(full.numpy()[:, ::2, ::2], half.numpy())
    fwd = jax.jit(lambda v, x, t: JNet(cfg, dtype=jnp.bfloat16).apply(
        v, x, t, return_argmax=True))
    ref = np.concatenate([np.asarray(fwd(vq, jnp.asarray(x[i:i + 1]),
                                         jnp.asarray(txt)))
                          for i in range(2)])
    agree = float(np.mean(full.numpy() == ref))
    print(f"head_fused=True labels vs JAX batch-1 program {agree:.4f}")
    assert agree >= 0.985, agree


# ---- the CUDA kernels against their plain versions (on the card) ----

@pytest.mark.gpu
@pytest.mark.parametrize("shape,k,dt", [
    ((2, 240, 240, 512), 150, torch.bfloat16),
    ((1, 7, 9, 64), 21, torch.float32)])
def test_fused_correlate_kernel_matches_plain(cuda_device, shape, k, dt):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, device=cuda_device, generator=g).to(dt)
    t = torch.randn(k, shape[-1], device=cuda_device, generator=g)
    got = fused_correlate(x, t)
    ref = fused_correlate_plain(x, t)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
    assert fused_correlate.launches > 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 240, 240, 150), (1, 7, 1, 21),
                                   (1, 1, 9, 3)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_upsample2x_argmax_kernel_matches_plain(cuda_device, shape, dt):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(shape, device=cuda_device, generator=g).to(dt)
    for lg in (x, -(x.abs() + 0.5)):
        got = upsample2x_argmax(lg)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, upsample2x_argmax_plain(lg),
                                   rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.int8, torch.bfloat16])
def test_head1_correlate_argmax_kernel_matches_plain(cuda_device, dt):
    x, sx, w1q, s1, b1, txt = _head1_inputs(7, 1, 120, 120, 256, 512, 150)
    dev = cuda_device
    xt = _t(x).to(dev).bfloat16()
    if dt == torch.int8:
        xt = torch.clamp(torch.round(xt.float() / float(sx)), -127, 127
                         ).to(torch.int8)
    args = (xt, torch.tensor(sx, device=dev),
            _t(np.ascontiguousarray(w1q.T)).to(dev), _t(s1).to(dev),
            _t(b1).to(dev), _t(txt).to(dev))
    got = head1_correlate_argmax_fused(*args)
    ref = head1_correlate_argmax_fused_plain(*args)
    torch.cuda.synchronize()
    assert float((got == ref).float().mean()) >= 0.999
