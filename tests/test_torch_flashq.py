"""The `fast_flashq` path (bench.py's rung: `fast_serving(cfg, 'static_cal')`
with `attn_impl='flashq'`, `ln_quant_fused=False`, `mlp_act_cal=False`)
against the JAX package's: the plain twin of kernel B8
(`flash_attention_qkv_fused`) against the Pallas kernel in interpret mode,
the unfused int8 block and the flashq ViT on carried-across quantized
trees, the tiny fast_flashq LSeg model and its calibration, and the
`gpu`-marked check of the CUDA kernel against its plain version. The flax
models of the JAX package are imported inside the tests that use them:
the card machine has JAX but no flax."""

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
    flash_attention_qkv_fused as j_qkv_fused,
)
from lseg_tpu.testing import tiny_vit_config
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.models.vit import Attention, Block, DenseViT
from lseg_tpu_torch.ops.flash_attention import (
    flash_attention_qkv_fused,
    flash_attention_qkv_fused_plain,
)
from lseg_tpu_torch.ops.quant import calibrate_act_scales, quantize_tree
from lseg_tpu_torch.utils.convert import from_jax_variables


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flashq_config(base):
    """bench.py's `fast_flashq` rung on `base`."""
    cfg = fast_serving(base, "static_cal")
    return dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, attn_impl="flashq", ln_quant_fused=False,
        mlp_act_cal=False))


# ---- B8: int8 qkv of pre-quantized rows + flash attention ----

def _qkv_inputs(seed, n=2, t=40, d=128):
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (n, t, d)).astype(np.int8)
    sx = (rng.rand(n, t, 1) * 0.02 + 0.005).astype(np.float32)
    wq = rng.randint(-127, 128, (d, 3 * d)).astype(np.int8)   # JAX (D, 3D)
    sw = (rng.rand(3 * d) * 1e-3 + 1e-4).astype(np.float32)
    bias = (rng.randn(3 * d) * 0.05).astype(np.float32)
    return xq, sx, wq, sw, bias


@pytest.mark.parametrize("valid_len", [40, 33])
def test_flash_attention_qkv_fused_plain_matches_pallas(valid_len):
    """(2, 40, 128), 2 heads, with every key valid and with keys masked
    past valid_len: bf16 within 2e-2 of max|ref| (the reference's own
    bound for its attention variants; P rounds to bf16 on both sides)."""
    xq, sx, wq, sw, bias = _qkv_inputs(0)
    scale = 64 ** -0.5
    ref = f32(j_qkv_fused(jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(wq),
                          jnp.asarray(sw), jnp.asarray(bias), 2, scale,
                          interpret=True, valid_len=valid_len))
    args = (_t(xq), _t(sx), _t(np.ascontiguousarray(wq.T)), _t(sw),
            _t(bias), 2, scale, valid_len)
    got = flash_attention_qkv_fused_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = float(np.abs(got.float().numpy() - ref).max())
    assert err <= 2e-2 * float(np.abs(ref).max()), err
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        flash_attention_qkv_fused(*args).float().numpy(),
        got.float().numpy())


def test_flash_attention_qkv_fused_checks_shapes():
    xq, sx, wq, sw, bias = (_t(a) for a in _qkv_inputs(1))
    w = wq.t().contiguous()
    with pytest.raises(ValueError, match="row scales"):
        flash_attention_qkv_fused(xq, sx[:, :-1], w, sw, bias, 2, 0.125)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_qkv_fused(xq, sx, w, sw, bias, 4, 0.125)


# ---- the unfused int8 block and the flashq ViT ----

@pytest.mark.parametrize("quant,fused", [("static", True), (False, False)])
def test_flashq_attention_routes(quant, fused):
    """'flashq' runs B8 only on a static-int8 model; unquantized it takes
    the flat flash kernel B6, as the reference's Attention does
    (lseg_tpu/models/vit.py:377-414)."""
    attn = Attention(128, 2, torch.bfloat16, "flashq", quant=quant)
    assert attn.qkv_fused == fused and attn.flat != fused
    assert not attn.ln_fused


def test_flashq_block_matches_jax():
    """One pre-norm block of the fast_flashq config (LN1 -> row quantize
    -> B8 -> int8 proj; LN2 -> int8 fc1 -> tanh GELU -> dynamic row
    quantize -> int8 fc2) against JAX's on the same random quantized
    parameters, bf16, T = 8 (which the reference does not pad). The port
    rounds GELU once from fp32 where JAX rounds each op to bf16, and a
    code may then sit one level apart: the block output stays within
    2e-2 of max|ref| and points the same way (cosine > 0.9999)."""
    from lseg_tpu.models.vit import Block as JBlock

    vit = flashq_config(tiny_parity_config()).vit
    d = vit.embed_dim
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 8, d) * 0.5).astype(np.float32)
    jb = JBlock(d, vit.num_heads, vit.mlp_ratio, jnp.bfloat16,
                attn_impl="flashq", quant="static", gelu=vit.mlp_gelu)
    params = _np_tree(jb.init(jax.random.PRNGKey(0),
                              jnp.asarray(x))["params"])
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
    ref = f32(jax.jit(lambda p, x: jb.apply({"params": p}, x)[0])(
        params, jnp.asarray(x, jnp.bfloat16)))
    blk = Block(vit, torch.bfloat16)
    blk.load_state_dict(from_jax_variables({"params": {"vit": {},
                                                       **params}}),
                        strict=True)
    assert blk.attn.qkv_fused and not blk.ln_quant
    with torch.no_grad():
        got = blk(_t(f32(jnp.asarray(x, jnp.bfloat16))).bfloat16())
    got = got.float().numpy()
    err = float(np.abs(got - ref).max())
    cos = float((got * ref).sum() / np.linalg.norm(got) / np.linalg.norm(ref))
    print(f"flashq block: max |port - jax| {err:.4g} of max|ref| "
          f"{np.abs(ref).max():.4g}, cosine {cos:.6f}")
    assert err <= 2e-2 * float(np.abs(ref).max()), err
    assert cos > 0.9999, cos


def test_flashq_vit_taps_match_jax():
    """The int8 flashq DenseViT against JAX's on one carried-across
    quantized tree (the shape of the reference's own flashq test,
    tests/test_pallas_ops.py:240-272): the block stack compounds
    rounding-point differences, so each tap is held by direction,
    cosine > 0.999."""
    from lseg_tpu.models.vit import DenseViT as JDenseViT
    from lseg_tpu.ops.quant import quantize_tree as j_quantize_tree

    base = tiny_vit_config().vit
    cfg = dataclasses.replace(base, embed_dim=128, num_heads=2,
                              attn_impl="flashq", quant_int8="static")
    x = np.random.RandomState(0).randn(2, 64, 48, 3).astype(np.float32)
    fp32_cfg = dataclasses.replace(cfg, attn_impl="xla", quant_int8=False)
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


# ---- the tiny fast_flashq LSeg model ----

@pytest.fixture(scope="module")
def carried():
    """A perturbed tiny head_dim-64 tree, quantized and calibrated in JAX
    on the fast_flashq config, and its conversion."""
    from lseg_tpu.models.lseg import LSegNet as JNet
    from lseg_tpu.ops.quant import calibrate_act_scales as j_calibrate
    from lseg_tpu.ops.quant import quantize_tree as j_quantize_tree

    base = tiny_parity_config()
    x, txt = inputs(0, out_c=base.out_c)
    v = jax_lseg_variables(base, x, txt)
    cfg = flashq_config(base)
    vq = dict(v)
    vq["params"] = j_quantize_tree(v["params"], decoder=True, act_scale=True,
                                   mlp_act_scale=False)
    vq = _np_tree(j_calibrate(JNet(cfg, dtype=jnp.bfloat16), vq,
                              jnp.asarray(x), None))
    return x, txt, v, cfg, vq, from_jax_variables(vq)


def _port(cfg, sd):
    model = LSegNet(cfg, dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True)
    return model


def _jax_apply(cfg, dtype, v, *args, **kw):
    from lseg_tpu.models.lseg import LSegNet as JNet

    return jax.jit(lambda v, *a: JNet(cfg, dtype=dtype).apply(v, *a, **kw))(
        v, *[jnp.asarray(a) for a in args])


def test_fast_flashq_builds_and_covers_every_leaf(carried):
    *_, cfg, vq, sd = carried
    model = _port(cfg, sd)
    blk = model.vit.blocks[0]
    assert blk.attn.qkv_fused and not blk.attn.flat and not blk.ln_quant
    assert not hasattr(blk, "act_scale")
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(vq))
    n_port = sum(t.numel() for t in model.state_dict().values())
    assert n_port == n_jax
    assert model.state_dict()["vit.blocks.0.attn.qkv.weight_q"].shape == (
        384, 128)


def test_fast_flashq_halfres_logits_within_bf16_bound(carried):
    """B4's half-res logits (with the per-pixel norm) of the port against
    JAX's on the same tree, by d_port <= 2 d_ref + 0.05, d_ref = JAX bf16
    vs JAX fp32."""
    x, txt, _, cfg, vq, sd = carried
    ref_bf16 = f32(_jax_apply(cfg, jnp.bfloat16, vq, x, txt,
                              return_halfres=True))
    ref_fp32 = f32(_jax_apply(fp32_reference_of(cfg), jnp.float32, vq, x,
                              txt, return_halfres=True))
    with torch.no_grad():
        got = _port(cfg, sd)(_t(x), _t(txt), return_halfres=True)
    assert got.dtype == torch.bfloat16 and got.shape == ref_bf16.shape
    d_port, d_ref = assert_bf16_bound(got.float().numpy(), ref_bf16,
                                      ref_fp32, "fast_flashq half-res logits")
    print(f"fast_flashq: d_port={d_port} d_ref={d_ref}")


def test_fast_flashq_argmax_matches_jitted_batch1(carried):
    """bench.py's call, `model(x, txt, return_argmax=True)` (the lowres B4
    head), against the jitted batch-1 JAX program. Random-init margins are
    near ties that the int8 grids amplify: the gate is the 0.985 of the
    other int8 heads (ROADMAP C)."""
    x, txt, _, cfg, vq, sd = carried
    with torch.no_grad():
        got = _port(cfg, sd)(_t(x), _t(txt), return_argmax=True)
    assert got.dtype == torch.int32 and got.shape == (2, 64, 96)
    ref = np.concatenate([np.asarray(_jax_apply(
        cfg, jnp.bfloat16, vq, x[i:i + 1], txt, return_argmax=True))
        for i in range(2)])
    agree = float(np.mean(got.numpy() == ref))
    print(f"fast_flashq labels vs JAX batch-1 program {agree:.4f}")
    assert agree >= 0.985, agree


def test_fast_flashq_calibration_tracks_reference(carried):
    """The port's own quantize_tree + calibrate_act_scales on the
    fast_flashq config, one batch without text, as bench.py calibrates:
    with `mlp_act_cal=False` the ViT has no calibrated site, and every
    decoder/head1 site is calibrated and tracks the reference's scale
    within 5% (the upstream drift of the bf16 forward, as for fast_cal in
    tests/test_torch_lseg_int8.py)."""
    x, _, v, cfg, _, sd_ref = carried
    model = _port(cfg, quantize_tree(from_jax_variables(v), decoder=True,
                                     act_scale=True, mlp_act_scale=False))
    calibrate_act_scales(model, _t(x), None)
    got = model.state_dict()
    sites = [k for k in sd_ref if k.endswith("act_scale")]
    assert len(sites) == 28 and not any(k.startswith("vit.") for k in sites)
    assert sorted(k for k in got if k.endswith("act_scale")) == sorted(sites)
    worst = max(abs(float(got[k]) - float(sd_ref[k])) / float(sd_ref[k])
                for k in sites)
    assert all(float(got[k]) != 1.0 for k in sites)
    print(f"worst relative act_scale deviation {worst:.3g}")
    assert worst <= 5e-2


# ---- the CUDA kernel against its plain version (on the card) ----

@pytest.mark.gpu
@pytest.mark.parametrize("t,valid_len", [(901, None), (904, 901)])
def test_flash_attention_qkv_fused_kernel_matches_plain(cuda_device, t,
                                                        valid_len):
    xq, sx, wq, sw, bias = _qkv_inputs(3, 2, t, 1024)
    dev = cuda_device
    args = (_t(xq).to(dev), _t(sx).to(dev),
            _t(np.ascontiguousarray(wq.T)).to(dev), _t(sw).to(dev),
            _t(bias).to(dev), 16, 64 ** -0.5, valid_len)
    before = flash_attention_qkv_fused.launches
    got = flash_attention_qkv_fused(*args)
    ref = flash_attention_qkv_fused_plain(*args)
    torch.cuda.synchronize()
    assert flash_attention_qkv_fused.launches == before + 1
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 2e-2 * float(ref.float().abs().max()), err
