"""The int8 modes of the ViT that the port builds since B2's int8 Q.K^T
mode and `QuantDense`: `attn_variant='i8qk'` (B2's `qk_int8`) and
`quant_int8=True` / 'dynamic', against the JAX package on the CPU, with
the Pallas kernels in interpret mode; every attention variant the JAX
package accepts on flashlnq and flashflat; the 'dpa', 'flash' and
'flash2' impls and bench.py's `xla_bf16` rung. The `gpu`-marked tests hold
B2's int8 Q.K^T mode against its plain twin on the card, and the int8
quantizers and `QuantDense` on the card against the CPU, where JAX runs
but flax is not installed: the flax modules of the JAX package are
imported inside the CPU tests."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    assert_bf16_bound,
    cuda_device,  # noqa: F401
    f32,
    fp32_reference_of,
    inputs,
    seeded_variables,
    tiny_parity_config,
)

from lseg_tpu.config import fast_serving as j_fast_serving
from lseg_tpu.ops.pallas_attention import _pair_softmax_attention
from lseg_tpu.ops.pallas_attention import (
    flash_attention_ln_qkv_fused_q8 as j_ln_qkv_q8,
)
from lseg_tpu_torch import fast_serving
from lseg_tpu_torch.models.layers import Dense, LayerNorm
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.models.vit import Attention, Block
from lseg_tpu_torch.ops.flash_attention import (
    _flat_attention_f32,
    flash_attention_ln_qkv_fused_q8,
    flash_attention_ln_qkv_fused_q8_plain,
)
from lseg_tpu_torch.ops.quant import (
    QuantDense,
    int8_matmul,
    quantize_cols,
    quantize_rows,
    quantize_tensor,
)
from lseg_tpu_torch.utils.convert import from_jax_variables, to_jax_variables

SCALE = 64 ** -0.5


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    """numpy fp32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _t(f32(j)).to(torch.bfloat16)


def _q8_inputs(seed, n=2, t=32, d=256):
    """B2's operands as tests/test_torch_int8_kernels.py draws them: the
    residual stream, LN params, an int8 (D, 3D) weight (the JAX layout)
    and its scales and bias (scores of a few units)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, t, d).astype(np.float32) * 0.3 + 0.05
    g = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    rng = np.random.RandomState(seed + 100)
    wq = rng.randint(-127, 128, (d, 3 * d)).astype(np.int8)
    sw = (rng.rand(3 * d) * 0.01).astype(np.float32)
    bias = (rng.randn(3 * d) * 0.05).astype(np.float32)
    return x, g, b, wq, sw, bias


def _variant(cfg, **kw):
    return dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, **kw))


@functools.lru_cache(maxsize=None)
def _jitted(cfg, dtype, kw):
    from lseg_tpu.models.lseg import LSegNet as JNet

    return jax.jit(lambda v, *a: JNet(cfg, dtype=dtype).apply(v, *a,
                                                              **dict(kw)))


def _jax(cfg, dtype, v, *args, **kw):
    """The jitted JAX forward, compiled once per (config, dtype, mode)."""
    fn = _jitted(cfg, dtype, tuple(sorted(kw.items())))
    return fn(v, *[jnp.asarray(a) for a in args])


@pytest.fixture(scope="module")
def tree():
    """Seeded tiny head_dim-64 fp32 weights (the port's init carried into
    the JAX tree and perturbed), inputs and the port's state_dict."""
    cfg = tiny_parity_config()
    x, txt = inputs(0, out_c=cfg.out_c)
    v = seeded_variables(cfg)
    return x, txt, v, from_jax_variables(v)


def _port(cfg, dtype, sd):
    model = LSegNet(cfg, dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model.eval()


# ---- B2's int8 Q.K^T mode ----

@pytest.mark.parametrize("valid_len", [None, 29])
def test_b2_i8qk_plain_matches_pallas(valid_len):
    """B2's plain twin with `qk_int8=True` against JAX's
    `flash_attention_ln_qkv_fused_q8(..., qk_int8=True)` in interpret
    mode: dequantized outputs within 2e-2 of max|ref|, the bound of the
    existing B2 test (measured 5.4e-3 unmasked, 4.3e-3 masked: jit lets
    XLA refold the score products and divisions, so scores sit an fp32
    ulp apart and a few output codes one level apart; the same twin
    against the reference run op by op is exact,
    `test_b2_i8qk_pair_interior_matches_reference`). The JAX package's
    own i8qk-against-default bound is 0.25. The wrapper takes the twin for
    a CPU tensor."""
    x, g, b, wq, sw, bias = _q8_inputs(2)
    xj, xt = _bf16(x)
    oj, sj = j_ln_qkv_q8(xj, jnp.asarray(g), jnp.asarray(b),
                         jnp.asarray(wq), jnp.asarray(sw), jnp.asarray(bias),
                         4, SCALE, valid_len=valid_len, qk_int8=True)
    args = (xt, _t(g), _t(b), _t(np.ascontiguousarray(wq.T)), _t(sw),
            _t(bias), 4, SCALE, valid_len)
    ot, st = flash_attention_ln_qkv_fused_q8_plain(*args, qk_int8=True)
    assert ot.dtype == torch.int8 and ot.shape == (2, 32, 256)
    ref = np.asarray(oj, np.float32) * np.asarray(sj)
    got = ot.numpy().astype(np.float32) * st.numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 2e-2, err
    # the default mode differs from the int8 Q.K^T mode on these inputs
    od, _ = flash_attention_ln_qkv_fused_q8_plain(*args)
    assert not torch.equal(od, ot)
    ow, sw_ = flash_attention_ln_qkv_fused_q8(*args, qk_int8=True)
    assert torch.equal(ow, ot) and torch.equal(sw_, st)


@pytest.mark.parametrize("valid_len", [32, 21])
def test_b2_i8qk_pair_interior_matches_reference(valid_len):
    """The twin's attention in the int8 Q.K^T mode against the TPU
    kernel's own `_pair_softmax_attention(..., qk_int8=True)` run op by op
    (no jit, so XLA refolds nothing) on one head pair of bf16 qkv: the
    per-row codes, the int32 Q.K^T and float(acc) * ((sq * scale) * sk)
    are exact on both sides; the pair outputs (fp32, before the bf16
    cast) agree to 1e-6 of max|ref| (exp in XLA against torch, the sums in
    another order)."""
    rng = np.random.RandomState(5)
    qkv = rng.randn(32, 384).astype(np.float32)
    qj, qt = _bf16(qkv)
    ref = np.asarray(_pair_softmax_attention(
        qj, SCALE, valid_len, jnp.float32, qk_int8=True))
    # the pair's (q2, k2, v2) slices as the port's (1, T, 3D) layout
    got, _ = _flat_attention_f32(qt.reshape(1, 32, 384), 2, SCALE,
                                 valid_len, qk_int8=True)
    err = np.abs(got[0].numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-6, err


@pytest.mark.gpu
@pytest.mark.parametrize("d,heads,t,valid_len", [
    (1024, 16, 901, None), (1024, 16, 904, 901), (768, 12, 226, None),
    (256, 4, 70, 61)])
def test_b2_i8qk_kernel_matches_plain(cuda_device, d, heads, t, valid_len):
    """B2's int8 Q.K^T mode on the card against its plain twin, within
    2e-2 of max|plain| (LNQKV_REL of chip_smoke.py), one launch counted in
    the mode; the default mode's kernel misses that twin by more than 2e-2
    (at these scores, rows nearly one-hot, the plain twins of the two
    modes differ by 0.32-0.94 of max|plain| on the CPU), so the check
    sees which kernel ran."""
    x, g, b, wq, sw, bias = _q8_inputs(3, n=2, t=t, d=d)
    dev = cuda_device
    args = (_t(x).to(dev, torch.bfloat16), _t(g).to(dev), _t(b).to(dev),
            _t(np.ascontiguousarray(wq.T)).to(dev), _t(sw).to(dev),
            _t(bias).to(dev), heads, SCALE, valid_len)
    before = flash_attention_ln_qkv_fused_q8.i8qk_launches
    oq, os_ = flash_attention_ln_qkv_fused_q8(*args, qk_int8=True)
    pq, ps = flash_attention_ln_qkv_fused_q8_plain(*args, qk_int8=True)
    torch.cuda.synchronize()
    assert flash_attention_ln_qkv_fused_q8.i8qk_launches == before + 1
    got, ref = oq.float() * os_, pq.float() * ps
    assert torch.isfinite(got).all()
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err < 2e-2, err
    dq, ds = flash_attention_ln_qkv_fused_q8(*args)
    miss = float((dq.float() * ds - ref).abs().max() / ref.abs().max())
    assert miss > 2e-2, miss


# ---- QuantDense and its helpers ----

def test_quantize_cols_and_int8_matmul_match_reference():
    """`quantize_cols` on the port's (out, in) storage and `int8_matmul`
    against the JAX package's on its (in, out) kernel, run op by op: codes,
    scales and bf16 outputs bit for bit."""
    from lseg_tpu.ops import quant as jq

    rng = np.random.RandomState(0)
    w = (rng.randn(96, 40) * 0.2).astype(np.float32)     # JAX (in, out)
    w[:, 3] = 0.0                                        # eps column
    x = (rng.randn(2, 7, 96)).astype(np.float32)
    cj, sj = jq.quantize_cols(jnp.asarray(w))
    ct, st = quantize_cols(_t(w.T.copy()))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj).T)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj).reshape(-1))
    assert st.shape == (40,)
    for dt, tdt in ((jnp.bfloat16, torch.bfloat16),
                    (jnp.float32, torch.float32)):
        ref = f32(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w), dt))
        got = int8_matmul(_t(x), _t(w.T.copy()), tdt)
        assert got.dtype == tdt and got.shape == (2, 7, 40)
        np.testing.assert_array_equal(got.float().numpy(), ref)


def test_quant_dense_matches_reference():
    """`QuantDense` against the JAX package's, on the same fp32 kernel and
    bias through `from_jax_variables`, bf16 and fp32 compute: bit for
    bit. Its state_dict is `Dense`'s (the same names and shapes)."""
    from lseg_tpu.ops import quant as jq

    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 64).astype(np.float32)
    for dt, tdt in ((jnp.bfloat16, torch.bfloat16),
                    (jnp.float32, torch.float32)):
        jd = jq.QuantDense(48, dtype=dt)
        v = {"params": {
            "kernel": (rng.randn(64, 48) * 0.1).astype(np.float32),
            "bias": (rng.randn(48) * 0.1).astype(np.float32)}}
        ref = f32(jd.apply(v, jnp.asarray(x)))
        mod = QuantDense(64, 48, tdt)
        mod.load_state_dict(from_jax_variables(v), strict=True)
        with torch.no_grad():
            got = mod(_t(x))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), ref)
    assert ({k: v.shape for k, v in mod.state_dict().items()}
            == {k: v.shape for k, v in Dense(64, 48).state_dict().items()})


def test_quant_dense_keeps_fp32_weights_in_a_bf16_model():
    """A bf16 model's `QuantDense` keeps its weight in fp32 (through
    `random_init_` and `load_state_dict`) and takes its codes from it: a
    weight whose bf16 rounding moves codes gives the fp32 weight's output,
    not the bf16-rounded one's."""
    from lseg_tpu_torch.models.layers import random_init_

    cfg = _variant(tiny_parity_config(), quant_int8="dynamic")
    model = random_init_(LSegNet(cfg, dtype=torch.bfloat16),
                         torch.Generator().manual_seed(0))
    dense = [m for m in model.modules() if isinstance(m, QuantDense)]
    assert len(dense) == 4 * len(model.vit.blocks)
    assert all(m.weight.dtype == torch.float32 for m in dense)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    assert all(m.weight.dtype == torch.float32 for m in dense)

    rng = np.random.RandomState(2)
    w = (rng.randn(32, 64) * 0.3).astype(np.float32)
    mod = QuantDense(64, 32, torch.bfloat16)
    with torch.no_grad():
        mod.weight.copy_(_t(w))
        mod.bias.zero_()
        x = _t(rng.randn(4, 64).astype(np.float32))
        got = mod(x)
        rounded = _t(w).bfloat16().float()
        assert not torch.equal(quantize_cols(rounded)[0],
                               quantize_cols(_t(w))[0])
        assert torch.equal(got, int8_matmul(x, _t(w)))
        assert not torch.equal(got, int8_matmul(x, rounded))


def test_quant_dense_refuses_grad():
    """Serving only, as the reference documents its dynamic mode: an input
    that requires grad raises under grad, and runs under no_grad."""
    mod = QuantDense(16, 8, torch.float32)
    mod.weight.data.normal_()
    x = torch.randn(2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="QuantDense"):
        mod(x)
    with torch.no_grad():
        assert mod(x).shape == (2, 8)


@pytest.mark.gpu
def test_quantizers_on_the_card_match_the_cpu(cuda_device):
    """`quantize_cols` of a ViT-L/16 qkv weight, `quantize_rows` of bf16
    rows, `quantize_tensor` and `QuantDense` on the card, bit for bit
    against their CPU results: every scale is an IEEE division by 127 on
    both (`div127`). A product with the reciprocal of 127, which the card
    takes for a Python scalar divisor, moves about one row scale in 25 of
    this weight's."""
    rng = np.random.RandomState(4)
    w = _t((rng.randn(3072, 1024) * 0.02).astype(np.float32))
    x = _t(rng.randn(2, 901, 1024).astype(np.float32)).to(torch.bfloat16)
    for fn, arg in ((quantize_cols, w), (quantize_rows, x),
                    (quantize_tensor, w)):
        codes, scale = fn(arg)
        dc, ds = fn(arg.to(cuda_device))
        assert torch.equal(dc.cpu(), codes), fn.__name__
        assert torch.equal(ds.cpu(), scale), fn.__name__
    mod = QuantDense(1024, 3072, torch.bfloat16)
    with torch.no_grad():
        mod.weight.copy_(w)
        mod.bias.copy_(_t((rng.randn(3072) * 0.05).astype(np.float32)))
        want = mod(x)
        got = mod.to(cuda_device)(x.to(cuda_device))
    assert torch.equal(got.cpu(), want)


# ---- the tiny model in the int8 modes ----

@pytest.mark.parametrize("quant", [True, "dynamic"])
@pytest.mark.parametrize("impl", ["xla", "flashflat", "dpa"])
def test_dynamic_int8_model_matches_jax(tree, impl, quant):
    """The tiny LSegNet with `quant_int8=True` / 'dynamic' (QuantDense on
    every projection; B6 on flashflat) against JAX's on the same fp32
    tree: half-res logits by d_port <= 2 d_ref + 0.05, d_ref = JAX bf16 of
    the config vs JAX fp32 of the dynamic 'xla' config (the three impls
    compute the same function in fp32)."""
    x, txt, v, sd = tree
    cfg = _variant(tiny_parity_config(), attn_impl=impl, quant_int8=quant)
    ref_bf16 = f32(_jax(cfg, jnp.bfloat16, v, x, txt, return_halfres=True))
    ref_fp32 = f32(_jax(_variant(cfg, attn_impl="xla", quant_int8=True),
                        jnp.float32, v, x, txt, return_halfres=True))
    model = _port(cfg, torch.bfloat16, sd)
    assert isinstance(model.vit.blocks[0].attn.qkv, QuantDense)
    assert isinstance(model.vit.blocks[0].mlp.fc2, QuantDense)
    with torch.no_grad():
        got = model(_t(x), _t(txt), return_halfres=True)
    assert_bf16_bound(got.float().numpy(), ref_bf16, ref_fp32,
                      f"{impl} quant_int8={quant!r} half-res logits")


def test_flash_keeps_float_projections():
    """JAX's 'flash' branch builds float heads-major projections and never
    quantizes them; its MLP does. With quant_int8=True the port's 'flash'
    block keeps `Dense` qkv and proj (`QuantDense` fc1 and fc2), its
    state_dict maps onto the JAX block's tree (`jax.eval_shape` of its
    init: JAX's stock TPU kernel behind 'flash' does not run on the CPU)
    leaf for leaf, with the same shapes, and its forward equals the port's
    'xla' block with float attention projections and the dynamic MLP, bit
    for bit."""
    from lseg_tpu.models.vit import Block as JBlock
    from lseg_tpu_torch.models.layers import random_init_

    vit = dataclasses.replace(tiny_parity_config().vit, attn_impl="flash",
                              quant_int8=True)
    d = vit.embed_dim
    blk = random_init_(Block(vit, torch.bfloat16),
                       torch.Generator().manual_seed(3))
    assert type(blk.attn.qkv) is Dense and type(blk.attn.proj) is Dense
    assert isinstance(blk.mlp.fc1, QuantDense)
    assert isinstance(blk.mlp.fc2, QuantDense)
    x = np.random.RandomState(4).randn(2, 9, d).astype(np.float32)
    shapes = jax.eval_shape(lambda: JBlock(
        d, vit.num_heads, vit.mlp_ratio, jnp.bfloat16, attn_impl="flash",
        quant=True).init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    ours = to_jax_variables(blk.state_dict())["params"]
    flat = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    mine = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    assert flat.keys() == mine.keys()
    for k, a in flat.items():
        assert tuple(a.shape) == mine[k].shape, k
    other = Block(dataclasses.replace(vit, attn_impl="xla"), torch.bfloat16)
    for name in ("qkv", "proj"):
        q = getattr(other.attn, name)
        setattr(other.attn, name, Dense(q.weight.shape[1], q.weight.shape[0],
                                        torch.bfloat16))
    other.load_state_dict(blk.state_dict(), strict=True)
    with torch.no_grad():
        xt = _t(x).bfloat16()
        assert torch.equal(blk(xt), other(xt))


def test_fast_cal_i8qk_labels_match_jax(tree):
    """The tiny `fast_serving(attn_variant='i8qk', 'static_cal')` model:
    the JAX package quantizes and calibrates the tree, the port serves it
    with B2 in its int8 Q.K^T mode (plain twin on the CPU), and its lowres
    argmax labels agree with the jitted batch-1 JAX program's by the rule
    of tests/test_torch_lseg_int8.py's argmax test: at least as well as
    JAX's own fp32 program agrees with it, and >= 0.985 where that one
    agrees better (its fixture). Random-init margins are near ties that
    the int8 grids amplify: on this seeded tree the port agrees on 0.9818
    and JAX's fp32 program on 0.9808 (the default B2 mode: 0.9844 and
    0.9694); on that file's tree 0.9889 and 0.9860."""
    from lseg_tpu.models.lseg import LSegNet as JNet
    from lseg_tpu.ops import quant as jq

    x, txt, v, _ = tree
    jcfg = j_fast_serving(_variant(tiny_parity_config(),
                                   attn_variant="i8qk"), "static_cal")
    cfg = fast_serving(_variant(tiny_parity_config(), attn_variant="i8qk"),
                       "static_cal")
    assert cfg == jcfg and cfg.vit.attn_variant == "i8qk"
    vq = dict(v)
    vq["params"] = jq.quantize_tree(v["params"], decoder=True,
                                    act_scale=True, mlp_act_scale=True)
    vq = jax.tree_util.tree_map(np.asarray, jq.calibrate_act_scales(
        JNet(cfg, dtype=jnp.bfloat16), vq, jnp.asarray(x), None))
    model = _port(cfg, torch.bfloat16, from_jax_variables(vq))
    assert all(b.attn.qk_int8 and b.attn.ln_fused
               for b in model.vit.blocks)
    with torch.no_grad():
        got = model(_t(x), _t(txt), return_argmax=True)
    ref = np.concatenate([np.asarray(_jax(
        cfg, jnp.bfloat16, vq, x[i:i + 1], txt, return_argmax=True))
        for i in range(2)])
    ref32 = np.concatenate([np.asarray(_jax(
        fp32_reference_of(cfg), jnp.float32, vq, x[i:i + 1], txt,
        return_argmax=True)) for i in range(2)])
    agree = float(np.mean(got.numpy() == ref))
    agree_fp32 = float(np.mean(ref32 == ref))
    assert agree >= min(0.985, agree_fp32), (agree, agree_fp32)


# ---- every attention variant the reference accepts ----

def _static_attention_params(rng, d):
    """JAX `_StaticDenseParams` leaves of qkv and proj (scores of a few
    units, as the B2 tests draw them)."""
    out = {}
    for name, n in (("qkv", 3 * d), ("proj", d)):
        out[name] = {
            "kernel_q": rng.randint(-127, 128, (d, n)).astype(np.int8),
            "scale": (rng.rand(n) * 0.004).astype(np.float32),
            "bias": (rng.randn(n) * 0.05).astype(np.float32)}
    return out


def _port_attention(params, d, heads, impl, quant, variant):
    attn = Attention(d, heads, torch.bfloat16, impl, torch.float32, quant,
                     variant=variant)
    sd = {k[len("attn."):]: t for k, t in from_jax_variables(
        {"params": {"attn": params}}).items()}
    attn.load_state_dict(sd, strict=True)
    return attn


@pytest.mark.parametrize("variant", ["v1", "lean", "lx2", "st", "leanst",
                                     "quad", "octo", "mono", "i8qk"])
def test_flashlnq_variants_match_jax(variant):
    """Each `attn_variant` JAX's flashlnq attention accepts, at a width
    with 8 heads (so 'quad' takes two pairs a grid step, 'octo' four,
    'mono' all four), JAX's Attention module (LN1 + B2 in interpret mode +
    the int8 projection) against the port's (`forward_ln`, B2's plain twin;
    the port runs every variant but 'i8qk' as B2's default mode): outputs
    within 2e-2 of max|ref|, the bound of the reference's own variant
    check. The block built from the config takes B2's int8 Q.K^T mode for
    'i8qk' alone."""
    from lseg_tpu.models.vit import Attention as JAttention

    d, heads, t = 512, 8, 24
    rng = np.random.RandomState(11)
    x = (rng.randn(1, t, d) * 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    params = _static_attention_params(rng, d)
    xj, xt = _bf16(x)
    ref = f32(JAttention(d, heads, jnp.bfloat16, "flashlnq",
                         quant="static", kernel_variant=variant).apply(
        {"params": params}, xj, ln=(jnp.asarray(g), jnp.asarray(b))))
    attn = _port_attention(params, d, heads, "flashlnq", "static", variant)
    norm = LayerNorm(d, 1e-6, torch.bfloat16)
    norm.weight.data, norm.bias.data = _t(g), _t(b)
    assert attn.ln_fused and attn.qk_int8 == (variant == "i8qk")
    with torch.no_grad():
        got = attn.forward_ln(xt, norm).float().numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 2e-2, err
    vit = dataclasses.replace(
        fast_serving(tiny_parity_config(), "static").vit,
        attn_variant=variant)
    assert Block(vit).attn.qk_int8 == (variant == "i8qk")


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_flashflat_variants_match_jax(variant):
    """Both flat flash kernel variants JAX's flashflat attention accepts
    ('v2': both heads of a pair staged, exp2 with log2 e folded in), JAX's
    Attention module (B6 in interpret mode) against the port's (B6's plain
    twin, which runs both as one): outputs within 2e-2 of max|ref|, the
    bound of the reference's own flash kernel check."""
    from lseg_tpu.models.vit import Attention as JAttention

    d, heads, t = 256, 4, 24
    rng = np.random.RandomState(12)
    x = rng.randn(1, t, d).astype(np.float32)
    params = {name: {"kernel": (rng.randn(d, n) / np.sqrt(d)).astype(
        np.float32), "bias": (rng.randn(n) * 0.05).astype(np.float32)}
        for name, n in (("qkv", 3 * d), ("proj", d))}
    xj, xt = _bf16(x)
    ref = f32(JAttention(d, heads, jnp.bfloat16, "flashflat",
                         kernel_variant=variant).apply({"params": params},
                                                       xj))
    attn = _port_attention(params, d, heads, "flashflat", False, variant)
    assert attn.flat
    with torch.no_grad():
        got = attn(xt).float().numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 2e-2, err


# ---- the other impls and bench.py's xla_bf16 rung ----

def test_dpa_model_matches_jax(tree):
    """`attn_impl='dpa'` (JAX's `jax.nn.dot_product_attention`; the port's
    einsum attention with fp32 scores): the tiny model's half-res logits by
    d_port <= 2 d_ref + 0.05, d_ref = JAX 'dpa' bf16 vs JAX 'xla' fp32 (the
    same function)."""
    x, txt, v, sd = tree
    base = tiny_parity_config()
    cfg = _variant(base, attn_impl="dpa")
    ref_bf16 = f32(_jax(cfg, jnp.bfloat16, v, x, txt, return_halfres=True))
    ref_fp32 = f32(_jax(base, jnp.float32, v, x, txt, return_halfres=True))
    with torch.no_grad():
        got = _port(cfg, torch.bfloat16, sd)(_t(x), _t(txt),
                                             return_halfres=True)
    assert_bf16_bound(got.float().numpy(), ref_bf16, ref_fp32,
                      "dpa half-res logits")


def test_xla_bf16_rung_matches_jax(tree):
    """bench.py's `xla_bf16` rung (`fast_serving(quant=False)` with
    attn_impl 'xla' and no patch kernel: bf16 scores, tanh GELU, the bf16
    head): the tiny model's half-res logits by d_port <= 2 d_ref + 0.05
    against JAX's, d_ref = JAX bf16 vs its fp32 twin, and its
    lowres-argmax labels on >= 0.99 of the pixels (the bound of
    tests/test_torch_lseg.py's bf16 argmax test)."""
    x, txt, v, sd = tree
    cfg = fast_serving(tiny_parity_config(), quant=False)
    cfg = _variant(cfg, attn_impl="xla", patch_fused=False)
    ref_bf16 = f32(_jax(cfg, jnp.bfloat16, v, x, txt, return_halfres=True))
    ref_fp32 = f32(_jax(fp32_reference_of(cfg), jnp.float32, v, x, txt,
                        return_halfres=True))
    model = _port(cfg, torch.bfloat16, sd)
    with torch.no_grad():
        got = model(_t(x), _t(txt), return_halfres=True)
    assert_bf16_bound(got.float().numpy(), ref_bf16, ref_fp32,
                      "xla_bf16 half-res logits")
    agree = float(np.mean(got.float().numpy().argmax(-1)
                          == ref_bf16.argmax(-1)))
    assert agree >= 0.99, agree


@pytest.mark.parametrize("impl", ["flash", "flash2"])
def test_flash_impls_match_jax_xla(tree, impl):
    """attn_impl 'flash' and 'flash2' (the port's einsum attention) against
    JAX's 'xla' path on the same tree: JAX's own 'flash' and 'flash2' run
    the stock Pallas TPU kernel (`lseg_tpu/models/vit.py`
    `_flash_attention`), which does not run on the CPU, and compute the
    same function. Half-res logits by d_port <= 2 d_ref + 0.05."""
    x, txt, v, sd = tree
    base = tiny_parity_config()
    ref_bf16 = f32(_jax(base, jnp.bfloat16, v, x, txt, return_halfres=True))
    ref_fp32 = f32(_jax(base, jnp.float32, v, x, txt, return_halfres=True))
    with torch.no_grad():
        got = _port(_variant(base, attn_impl=impl), torch.bfloat16, sd)(
            _t(x), _t(txt), return_halfres=True)
    assert_bf16_bound(got.float().numpy(), ref_bf16, ref_fp32,
                      f"{impl} half-res logits")
