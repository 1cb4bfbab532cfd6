"""The port's int8 primitives (`lseg_tpu_torch.ops.quant`) against the
JAX package's (`lseg_tpu.ops.quant`) on the same seeded inputs: int8
codes and scales equal, bf16 outputs within one bf16 ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import f32, inputs, jax_lseg_variables, tiny_parity_config

from lseg_tpu.ops import quant as jq
from lseg_tpu_torch.ops import quant as tq
from lseg_tpu_torch.utils.convert import from_jax_variables


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_input(seed, shape, scale=1.0):
    """Seeded values rounded to bf16: (jax bf16, torch bf16)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, _t(f32(j)).to(torch.bfloat16)


def _weights(seed, k, n):
    rng = np.random.RandomState(seed)
    wq = rng.randint(-127, 128, (k, n)).astype(np.int8)      # JAX (K, N)
    sw = (rng.rand(n) * 0.01 + 1e-4).astype(np.float32)
    b = (rng.randn(n) * 0.1).astype(np.float32)
    return wq, sw, b


def _assert_within_bf16_ulp(got, ref):
    got = got.float().numpy()
    ref = f32(ref)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= ulp), np.abs(got - ref).max()


def test_quantize_rows_and_tensor_equal_reference():
    xj, xt = _bf16_input(0, (3, 5, 48), 2.0)
    for jfn, tfn in ((jq.quantize_rows, tq.quantize_rows),
                     (jq.quantize_tensor, tq.quantize_tensor)):
        qj, sj = jfn(xj)
        qt, st = tfn(xt)
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy().reshape(np.shape(sj)),
                                      np.asarray(sj))
    # an all-zero row takes the eps floor, codes 0
    q, s = tq.quantize_rows(torch.zeros(2, 8))
    assert float(s.max()) == pytest.approx(1e-8 / 127) and int(q.abs().max()) == 0


@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_matmuls_match_reference(with_bias):
    """int8_matmul_prequant (dynamic rows) and int8_matmul_prequant_act
    (pre-quantized rows, bias after the bf16 cast)."""
    xj, xt = _bf16_input(1, (2, 7, 64))
    wq, sw, b = _weights(2, 64, 40)
    wt = _t(np.ascontiguousarray(wq.T))
    ref = jq.int8_matmul_prequant(xj, jnp.asarray(wq), jnp.asarray(sw))
    got = tq.int8_matmul_prequant(xt, wt, _t(sw))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 7, 40)
    _assert_within_bf16_ulp(got, ref)
    xqj, sxj = jq.quantize_rows(xj)
    bias_j = jnp.asarray(b) if with_bias else None
    ref = jq.int8_matmul_prequant_act(xqj, sxj, jnp.asarray(wq),
                                      jnp.asarray(sw), bias_j)
    xq, sx = tq.quantize_rows(xt)
    got = tq.int8_matmul_prequant_act(xq, sx, wt, _t(sw),
                                      _t(b) if with_bias else None)
    _assert_within_bf16_ulp(got, ref)


def test_static_quant_dense_matches_reference():
    xj, xt = _bf16_input(3, (2, 9, 64))
    wq, sw, b = _weights(4, 64, 32)
    ref = jq.StaticQuantDense(32, dtype=jnp.bfloat16).apply(
        {"params": {"kernel_q": wq, "scale": sw, "bias": b}}, xj)
    dense = tq.StaticQuantDense(64, 32)
    dense.load_state_dict(from_jax_variables({"params": {
        "vit": {}, "kernel_q": wq, "scale": sw, "bias": b}}))
    with torch.no_grad():
        got = dense(xt)
    _assert_within_bf16_ulp(got, ref)


@pytest.mark.parametrize("kernel,stride,static_act", [
    (3, 1, False), (3, 1, True), (3, 2, False), (3, 2, True),
    (1, 1, False), (1, 1, True)])
def test_static_quant_conv_matches_reference(kernel, stride, static_act):
    """3x3 stride 1 (scratch, RCU), 3x3 stride 2 (reassemble4 resample)
    and 1x1 (reassemble proj, out_conv, head1); calibrated or dynamic
    activation scale."""
    xj, xt = _bf16_input(5, (2, 9, 11, 32))
    rng = np.random.RandomState(6)
    wq = rng.randint(-127, 128, (kernel, kernel, 32, 48)).astype(np.int8)
    sw = (rng.rand(48) * 0.01).astype(np.float32)
    b = (rng.randn(48) * 0.1).astype(np.float32)
    pad = kernel // 2
    params = {"kernel_q": wq, "scale": sw, "bias": b}
    if static_act:
        params["act_scale"] = np.float32(2.5)   # clips the tails
    ref = jq.StaticQuantConv(48, (kernel, kernel), strides=(stride, stride),
                             padding=((pad, pad), (pad, pad)),
                             static_act=static_act).apply(
        {"params": params}, xj)
    conv = tq.StaticQuantConv(32, 48, kernel, stride, pad,
                              static_act=static_act)
    conv.load_state_dict(from_jax_variables({"params": {"vit": {},
                                                        **params}}))
    with torch.no_grad():
        got = conv(xt)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    _assert_within_bf16_ulp(got, ref)


@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (1, 1)])
def test_conv_calibration_matches_reference(kernel, stride):
    """A calibrating StaticQuantConv records max|x| of its input and
    keeps the dynamic math, as the reference's sow does: on the same
    input the scale and the output agree exactly."""
    rng = np.random.RandomState(7)
    xj, xt = _bf16_input(7, (2, 9, 11, 32))
    wq = rng.randint(-127, 128, (kernel, kernel, 32, 48)).astype(np.int8)
    sw = (rng.rand(48) * 0.01).astype(np.float32)
    b = (rng.randn(48) * 0.1).astype(np.float32)
    pad = kernel // 2
    params = {"kernel_q": wq, "scale": sw, "bias": b,
              "act_scale": np.float32(1.0)}
    yj, st = jq.StaticQuantConv(
        48, (kernel, kernel), strides=(stride, stride),
        padding=((pad, pad), (pad, pad)), static_act=True).apply(
        {"params": params}, xj, mutable=["quant_cal"])
    amax = st["quant_cal"]["amax"]
    amax = float(np.asarray(amax[0] if isinstance(amax, (tuple, list))
                            else amax))
    conv = tq.StaticQuantConv(32, 48, kernel, stride, pad, static_act=True)
    conv.load_state_dict(from_jax_variables({"params": {"vit": {},
                                                        **params}}))
    tq.calibrate_act_scales(conv, xt)
    assert float(conv.act_scale) == pytest.approx(amax, rel=1e-6)
    conv.calibrating = True
    with torch.no_grad():
        y = conv(xt)
    conv.calibrating = False
    np.testing.assert_array_equal(y.float().numpy(), f32(yj))
    # serving uses the calibrated scale: on the calibration batch that is
    # the dynamic scale, so the output is the same
    with torch.no_grad():
        np.testing.assert_array_equal(conv(xt).float().numpy(), f32(yj))


@pytest.fixture(scope="module")
def fp32_variables():
    cfg = tiny_parity_config()
    x, txt = inputs(0, out_c=cfg.out_c)
    return jax_lseg_variables(cfg, x, txt)


@pytest.mark.parametrize("decoder,act_scale", [
    (False, False), (True, False), (True, True)])
def test_quantize_tree_matches_reference(fp32_variables, decoder,
                                         act_scale):
    """The port's quantize_tree on the port's fp32 state_dict gives the
    codes, scales and placeholders of the reference's on the JAX tree."""
    v = fp32_variables
    vq = dict(v, params=jq.quantize_tree(v["params"], decoder=decoder,
                                         act_scale=act_scale))
    ref = from_jax_variables(jax.tree_util.tree_map(np.asarray, vq))
    got = tq.quantize_tree(from_jax_variables(v), decoder=decoder,
                           act_scale=act_scale)
    assert sorted(got) == sorted(ref)
    assert any(k.endswith("weight_q") for k in got)
    assert any(k.startswith("head1.weight_q") for k in got) == decoder
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0,
                                   msg=lambda m: f"{k}: {m}")
