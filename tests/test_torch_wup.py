"""The two remaining fused head forms against the JAX package's: the plain
twins of kernels B14 (`head1_correlate_wup_fused`) and B13
(`head1_correlate_upsample_argmax`) against the Pallas kernels in
interpret mode, the `head_fused='wup'` model's full-resolution logits and
its routing of the other calls, and the `gpu`-marked checks of both CUDA
kernels against their plain versions. The flax models of the JAX package
are imported inside the fixture that uses them: the card machine has JAX
but no flax."""

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
from lseg_tpu.ops.pallas_correlation import (
    head1_correlate_upsample_argmax as j_b13,
)
from lseg_tpu.ops.pallas_correlation import (
    head1_correlate_wup_fused as j_b14,
)
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.ops.head1_correlate import (
    head1_correlate_fused,
    head1_correlate_fused_plain,
    head1_correlate_upsample_argmax,
    head1_correlate_upsample_argmax_plain,
    head1_correlate_wup_fused,
    head1_correlate_wup_fused_plain,
    upsample_argmax_bf16,
    w_interp_bf16,
)
from lseg_tpu_torch.utils.convert import from_jax_variables


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes(seed, n, h, w, c, e, k, neg=False):
    """Seeded head inputs as the reference's tests make them, in both
    layouts: (jax args, port args). `neg` makes every logit negative
    (positive text rows, embeddings pushed below zero by the bias)."""
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (n, h, w, c)).astype(np.int8)
    w1q = rng.randint(-127, 128, (c, e)).astype(np.int8)     # JAX (C, E)
    s1 = (rng.rand(e) * 0.01 + 1e-3).astype(np.float32)
    b1 = (rng.randn(e) * 0.1).astype(np.float32)
    txt = rng.randn(k, e).astype(np.float32)
    if neg:
        s1 = (rng.rand(e) * 1e-4 + 1e-5).astype(np.float32)
        b1 = -(rng.rand(e) + 1.0).astype(np.float32)
        txt = (rng.rand(k, e) + 0.1).astype(np.float32)
    sx = np.float32(0.02)
    jargs = (jnp.asarray(xq), jnp.asarray(sx),
             jnp.asarray(w1q.reshape(1, 1, c, e)), jnp.asarray(s1),
             jnp.asarray(b1), jnp.asarray(txt))
    targs = (_t(xq), torch.tensor(sx), _t(np.ascontiguousarray(w1q.T)),
             _t(s1), _t(b1), _t(txt))
    return jargs, targs


# ---- B14: head1 + normalized correlation + x2 W-interp ----

@pytest.mark.parametrize("n,h,w,c,e,k", [(2, 8, 16, 32, 64, 7),
                                         (1, 4, 9, 64, 128, 5)])
def test_head1_correlate_wup_plain_matches_pallas(n, h, w, c, e, k):
    """At the sizes of the reference's own check
    (tests/test_correlation_parity.py:97-115) and an odd width: bf16
    within rtol/atol 1e-2, K unpadded."""
    jargs, targs = _codes(0, n, h, w, c, e, k)
    ref = f32(j_b14(*jargs, rows=4, interpret=True))
    got = head1_correlate_wup_fused_plain(*targs)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape == (
        n, h, 2 * w, k)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-2,
                               atol=1e-2)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        head1_correlate_wup_fused(*targs).float().numpy(),
        got.float().numpy())


def test_head1_correlate_wup_plain_is_w_interp_of_b4():
    """The W-interp of B4's normalized logits, two taps per output column:
    the even columns of an align-corners x2 interp of W = 2 are the
    source columns, and every output lies between its two taps."""
    _, targs = _codes(1, 1, 3, 2, 32, 128, 6)
    lo = head1_correlate_fused_plain(*targs).float()
    up = head1_correlate_wup_fused_plain(*targs).float()
    np.testing.assert_array_equal(up[:, :, 0].numpy(), lo[:, :, 0].numpy())
    np.testing.assert_array_equal(up[:, :, 3].numpy(), lo[:, :, 1].numpy())
    lo_min = torch.minimum(lo[:, :, 0], lo[:, :, 1])
    lo_max = torch.maximum(lo[:, :, 0], lo[:, :, 1])
    for j in (1, 2):
        assert bool((up[:, :, j] >= lo_min).all() and
                    (up[:, :, j] <= lo_max).all())


# ---- B13: head1 + correlation + x2 upsample + argmax ----

@pytest.mark.parametrize("case", ["reference", "all-negative"])
def test_head1_correlate_upsample_argmax_plain_matches_pallas(case):
    """At the sizes of the reference's own check
    (tests/test_correlation_parity.py:67-81), and with every logit
    negative and K = 13, not a multiple of 8, so that no padded label can
    win: >= 0.999 of the labels equal (the same bf16 operands, fp32 sums
    in another order, so a label may flip at an fp32 tie)."""
    neg = case == "all-negative"
    shape = (2, 16, 16, 32, 64, 13 if neg else 7)
    jargs, targs = _codes(2, *shape, neg=neg)
    if neg:
        lo = head1_correlate_fused_plain(*targs)
        assert bool((lo < 0).all())
    ref = np.asarray(j_b13(*jargs, rows=4, interpret=True))
    got = head1_correlate_upsample_argmax_plain(*targs)
    assert got.dtype == torch.int32 and got.shape == ref.shape == (2, 32, 32)
    agree = float(np.mean(got.numpy() == ref))
    assert agree >= 0.999, agree
    assert 0 <= int(got.min()) and int(got.max()) < shape[-1]
    np.testing.assert_array_equal(
        head1_correlate_upsample_argmax(*targs).numpy(), got.numpy())


@pytest.mark.parametrize("shape", [(1, 1, 5, 32, 128, 4),
                                   (1, 3, 1, 32, 128, 4)])
def test_head1_correlate_upsample_argmax_plain_edges(shape):
    """One source row or one source column (the x2 operator of a size-1
    axis copies it) against the Pallas kernel with one band per source
    row; first index on ties."""
    jargs, targs = _codes(3, *shape)
    got = head1_correlate_upsample_argmax_plain(*targs)
    ref = np.asarray(j_b13(*jargs, rows=1, interpret=True))
    assert got.shape == ref.shape == (1, 2 * shape[1], 2 * shape[2])
    np.testing.assert_array_equal(got.numpy(), ref)


def test_head1_correlate_upsample_argmax_plain_ties():
    """A text matrix with two equal rows ties everywhere: the first
    wins."""
    _, (xq, sx, w, s1, b1, txt) = _codes(4, 1, 4, 4, 32, 128, 3)
    txt = torch.stack([txt[1], txt[0], txt[0]])
    got = head1_correlate_upsample_argmax_plain(xq, sx, w, s1, b1, txt)
    assert not bool((got == 2).any())


# ---- the head_fused='wup' model ----

@pytest.fixture(scope="module")
def wup_tree():
    """A perturbed tiny head_dim-64 tree quantized and calibrated in JAX
    (static_cal), the `head_fused='wup'` config, and its conversion."""
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
    cfg = dataclasses.replace(cfg, head_fused="wup")
    return x, txt, cfg, vq, from_jax_variables(vq)


def _port(cfg, sd):
    model = LSegNet(cfg, dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True)
    return model


def test_wup_model_logits_within_bf16_bound(wup_tree):
    """`model(x, txt)` runs B14 (its plain twin here) and the bf16
    H-interp: its (N, H, W, K) fp32 logits against JAX's, which runs the
    Pallas B14 in interpret mode, by d_port <= 2 d_ref + 0.05, d_ref =
    JAX's 'wup' bf16 model vs its fp32 reference on the same tree."""
    from lseg_tpu.models.lseg import LSegNet as JNet

    x, txt, cfg, vq, sd = wup_tree

    def jax_logits(c, dt):
        return f32(jax.jit(lambda v, x, t: JNet(c, dtype=dt).apply(
            v, x, t))(vq, jnp.asarray(x), jnp.asarray(txt)))

    ref_bf16 = jax_logits(cfg, jnp.bfloat16)
    ref_fp32 = jax_logits(fp32_reference_of(cfg), jnp.float32)
    with torch.no_grad():
        got = _port(cfg, sd)(_t(x), _t(txt))
    assert got.dtype == torch.float32 and got.shape == ref_bf16.shape == (
        2, 64, 96, 5)
    d_port, d_ref = assert_bf16_bound(got.numpy(), ref_bf16, ref_fp32,
                                      "'wup' full-resolution logits")
    print(f"wup: d_port={d_port} d_ref={d_ref}")


def test_wup_model_routes_each_call(wup_tree):
    """Under `head_fused='wup'` the logits call takes B14 and only that;
    `return_argmax` keeps taking B5 and `return_halfres` B4 with the norm,
    as the reference's branches do (lseg_tpu/models/lseg.py:247-278); the
    logits are the bf16 H-interp of B14's output."""
    from lseg_tpu_torch.ops.resize import resize_bilinear

    x, txt, cfg, _, sd = wup_tree
    model = _port(cfg, sd)
    calls = []
    for name in ("_fused_wup_head", "_fused_argmax_head", "_fused_head"):
        fn = getattr(model, name)
        setattr(model, name, (lambda f, n: lambda *a, **k: calls.append(n)
                              or f(*a, **k))(fn, name))
    seen = {}
    hook = model.refinenet1.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("path1", out))
    with torch.no_grad():
        logits = model(_t(x), _t(txt))
        assert calls == ["_fused_wup_head"]
        wup = model._fused_wup_head(seen["path1"], _t(txt))
        model(_t(x), _t(txt), return_argmax=True)
        model(_t(x), _t(txt), return_halfres=True)
    hook.remove()
    assert calls[2:] == ["_fused_argmax_head", "_fused_head"]
    assert wup.shape == (2, 32, 96, 5) and wup.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        logits.numpy(),
        resize_bilinear(wup, 64, 96, align_corners=True,
                        compute_dtype=torch.bfloat16).float().numpy())


def test_wup_b13_labels_track_wup_logits(wup_tree):
    """B13 on the served path1's codes gives the labels of the x2
    upsample of B4's normalized logits; the argmax of the 'wup' model's
    logits (bf16 H-interp after B14's W-interp) rounds in another order,
    so the two agree up to near ties of the random-init logits."""
    x, txt, cfg, _, sd = wup_tree
    model = _port(cfg, sd)
    seen = {}
    hook = model.refinenet1.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("path1", out))
    with torch.no_grad():
        logits = model(_t(x), _t(txt))
    hook.remove()
    h1 = model.head1
    xq, sx = model._head1_codes(seen["path1"])
    labels = head1_correlate_upsample_argmax(
        xq.contiguous(), sx, h1.weight_q, h1.scale, h1.bias, _t(txt),
        cfg.logit_scale)
    assert labels.shape == (2, 64, 96) and labels.dtype == torch.int32
    agree = float((labels == logits.argmax(-1)).float().mean())
    print(f"B13 labels vs argmax of the 'wup' logits {agree:.4f}")
    assert agree >= 0.95, agree


# ---- the CUDA kernels against their plain versions (on the card) ----

@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 60, 240, 256, 512, 150),
                                   (2, 5, 9, 32, 128, 7)])
def test_head1_correlate_wup_kernel_matches_plain(cuda_device, shape):
    """Against the plain twin: the kernel's logits may sit one bf16 ulp
    from the plain ones (fp32 sums in another order), the W-interp
    carries that ulp of each tap into outputs that can cancel to near
    zero, and each side rounds its blend once more, so the bound is two
    ulps of the interpolated magnitudes (`w_interp_bf16` of |logits|) +
    1e-3. Against the W-interp of kernel B4's logits on the same inputs
    (the same tile code): bit for bit."""
    _, targs = _codes(5, *shape)
    args = [a.to(cuda_device) for a in targs]
    before = head1_correlate_wup_fused.launches
    got = head1_correlate_wup_fused(*args)
    ref = head1_correlate_wup_fused_plain(*args)
    lo = head1_correlate_fused(*args)
    torch.cuda.synchronize()
    assert head1_correlate_wup_fused.launches == before + 1
    env = w_interp_bf16(head1_correlate_fused_plain(*args).abs()).float()
    assert bool(((got.float() - ref.float()).abs()
                 <= 2 ** -6 * env + 1e-3).all())
    assert torch.equal(got, w_interp_bf16(lo))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,neg", [((1, 60, 240, 256, 512, 150), False),
                                       ((2, 5, 9, 32, 128, 13), True),
                                       ((1, 1, 3, 32, 128, 4), False)])
def test_head1_correlate_upsample_argmax_kernel_matches_plain(
        cuda_device, shape, neg):
    """>= 0.999 of the labels equal to the plain twin's; all of them equal
    to the plain tail (`upsample_argmax_bf16`) of kernel B4's logits on
    the same inputs, which it rounds op by op."""
    _, targs = _codes(6, *shape, neg=neg)
    args = [a.to(cuda_device) for a in targs]
    before = head1_correlate_upsample_argmax.launches
    got = head1_correlate_upsample_argmax(*args)
    ref = head1_correlate_upsample_argmax_plain(*args)
    tail = upsample_argmax_bf16(head1_correlate_fused(*args))
    torch.cuda.synchronize()
    assert head1_correlate_upsample_argmax.launches == before + 1
    assert float((got == ref).float().mean()) >= 0.999
    assert torch.equal(got, tail)
