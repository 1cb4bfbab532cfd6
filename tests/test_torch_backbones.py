"""The other backbones and heads of the port against the JAX package's:
the ViT-B/16- and ViT-B/32-shaped models (the position embedding resized
to 480 x 480's grids, the x8 reassemble), twelve heads on each attention
impl the parity and fast configs pick, the CLIP text tower at the RN50x4
and RN50x16 widths, the arch_option 1 / 2 head blocks through `LSegNet`
and `make_predictor`, and the ResNet backbone (`tiny_rn_config`) in eval
and train mode and under `fast_serving(..., 'static_cal')`.

Weights come from the port's seeded init carried into the JAX tree
(`torch_parity.seeded_variables`), whose structure
`test_port_tree_is_the_jax_tree` holds to JAX's own init. The JAX
package's models are imported inside the tests, so that the `gpu` tests
at the end, which hold the kernels at the new widths against their plain
twins on the card (B4, B10 and B14 at E = 640 and 768; B2 and B3 at
D = 768 with ViT-B/32's T = 226 at 480 x 480), collect where flax is
missing."""

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
    perturb,
    seeded_variables,
    tiny_parity_config,
    tiny_text_config,
    tiny_vitb_config,
)

from lseg_tpu.config import LSegConfig, ViTConfig, fast_serving
from lseg_tpu.testing import tiny_rn_config
from lseg_tpu_torch.engine.serve import make_predictor
from lseg_tpu_torch.models.layers import random_init_
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.utils.convert import (
    from_jax_text_params,
    from_jax_variables,
    to_jax_variables,
)

# the fp32 tolerances of tests/test_torch_lseg.py (logits) and
# tests/test_torch_vit.py (taps)
FP32_LOGITS_ATOL = 1e-3
TAPS_TOL = 1e-4


def _arch(option, depth=2):
    return dataclasses.replace(tiny_parity_config(), arch_option=option,
                               block_depth=depth)


CASES = {
    "vitb16": lambda: tiny_vitb_config(16),
    "vitb32": lambda: tiny_vitb_config(32),
    "resnet": tiny_rn_config,
    "arch1": lambda: _arch(1),
    "arch2": lambda: _arch(2),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(cfg, x, txt, JAX variables, the port's state_dict)."""
    cfg = CASES[name]()
    x, txt = inputs(0, out_c=cfg.out_c)
    v = seeded_variables(cfg)
    return cfg, x, txt, v, from_jax_variables(v)


@functools.lru_cache(maxsize=None)
def _jitted(cfg, dtype, kw):
    from lseg_tpu.models.lseg import LSegNet as JNet

    return jax.jit(lambda v, *a: JNet(cfg, dtype=dtype).apply(
        v, *a, **dict(kw)))


def _jax(cfg, dtype, v, *args, **kw):
    return _jitted(cfg, dtype, tuple(sorted(kw.items())))(
        v, *[jnp.asarray(a) for a in args])


def _port(cfg, sd, dtype=torch.float32):
    model = LSegNet(cfg, dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _shapes(tree):
    return {jax.tree_util.keystr(p): tuple(np.shape(a)) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("case", list(CASES))
def test_port_tree_is_the_jax_tree(case):
    """The port's state_dict, carried into the JAX tree, has every leaf of
    JAX's own init and no other, at the same shapes (ResNet's batch
    statistics and the head block's shared 3x3 kernel included)."""
    from lseg_tpu.models.lseg import LSegNet as JNet

    cfg, x, txt, v, _ = _case(case)
    ref = jax.eval_shape(lambda a, b: JNet(cfg).init(
        jax.random.PRNGKey(0), a, b), jnp.asarray(x), jnp.asarray(txt))
    assert _shapes(v) == _shapes(ref)


@pytest.mark.parametrize("case", list(CASES))
def test_fp32_logits_match_jax(case):
    cfg, x, txt, v, sd = _case(case)
    ref = f32(_jax(cfg, jnp.float32, v, x, txt))
    with torch.no_grad():
        got = _port(cfg, sd)(torch.from_numpy(x), torch.from_numpy(txt))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    dev = float(np.max(np.abs(got.numpy() - ref)))
    assert dev <= FP32_LOGITS_ATOL, f"{case}: max abs logit deviation {dev}"


def test_vitb32_fast_bf16_logits_within_bound():
    """ViT-B/32's shape under `fast_serving(quant=False)` (flashflat, the
    patch kernel at P = 32, tanh GELU, bf16 head), by the d_port <= 2 d_ref
    rule."""
    base, x, txt, v, sd = _case("vitb32")
    cfg = fast_serving(base, quant=False)
    assert cfg.vit.attn_impl == "flashflat" and cfg.vit.patch_fused
    ref_bf16 = f32(_jax(cfg, jnp.bfloat16, v, x, txt))
    ref_fp32 = f32(_jax(fp32_reference_of(cfg), jnp.float32, v, x, txt))
    with torch.no_grad():
        got = _port(cfg, sd, torch.bfloat16)(torch.from_numpy(x),
                                             torch.from_numpy(txt))
    assert_bf16_bound(got.numpy(), ref_bf16, ref_fp32, "ViT-B/32 logits")


def _vit_state(vit_cfg, seed):
    """A seeded port `DenseViT` of `vit_cfg` and its JAX params."""
    from lseg_tpu_torch.models.vit import DenseViT

    vit = random_init_(DenseViT(vit_cfg),
                       torch.Generator().manual_seed(seed))
    sd = {f"vit.{k}": t for k, t in vit.state_dict().items()}
    params = perturb(to_jax_variables(sd, vit_cfg.hooks))["params"]["vit"]
    return {k[len("vit."):]: t for k, t in from_jax_variables(
        {"params": {"vit": params}}).items()}, params


def _taps(vit_cfg, dtype, params, x):
    from lseg_tpu.models.vit import DenseViT as JViT

    taps, grid = jax.jit(lambda p, x: JViT(vit_cfg, dtype=dtype).apply(
        {"params": p}, x))(params, jnp.asarray(x))
    return [f32(t) for t in taps], tuple(grid)


def _port_taps(vit_cfg, dtype, sd, x):
    from lseg_tpu_torch.models.vit import DenseViT

    vit = DenseViT(vit_cfg, dtype)
    vit.load_state_dict(sd, strict=True)
    with torch.no_grad():
        taps, grid = vit(torch.from_numpy(x))
    return [t.float().numpy() for t in taps], grid, vit


@pytest.mark.parametrize("patch,grid0,grid", [(16, 24, 30), (32, 12, 15)])
def test_pos_embed_resized_to_the_480_grid(patch, grid0, grid):
    """ViT-B/16's and ViT-B/32's pretraining grids (24, 12) resized to the
    30 x 30 and 15 x 15 grids of a 480 x 480 input (align_corners=False),
    through a narrow four-block encoder: fp32 taps as the reference's."""
    vit_cfg = ViTConfig(patch_size=patch, embed_dim=64, num_heads=1,
                        depth=4, hooks=(0, 1, 2, 3), pretrain_grid=grid0)
    sd, params = _vit_state(vit_cfg, 3)
    x = np.random.RandomState(4).randn(1, 480, 480, 3).astype(np.float32)
    ref, rgrid = _taps(vit_cfg, jnp.float32, params, x)
    got, ggrid, _ = _port_taps(vit_cfg, torch.float32, sd, x)
    assert ggrid == rgrid == (grid, grid)
    for r, g in zip(ref, got):
        assert g.shape == r.shape == (1, 1 + grid * grid, 64)
        np.testing.assert_allclose(g, r, rtol=TAPS_TOL, atol=TAPS_TOL)


@functools.lru_cache(maxsize=None)
def _twelve_heads():
    """ViT-B's width and heads (768, 12 of 64) in a four-block encoder."""
    cfg = LSegConfig(features=32, out_c=64, vit=ViTConfig(
        embed_dim=768, num_heads=12, depth=4, hooks=(0, 1, 2, 3),
        post_channels=(16, 32, 64, 64), pretrain_grid=4))
    sd, params = _vit_state(cfg.vit, 5)
    x = np.random.RandomState(6).randn(1, 64, 96, 3).astype(np.float32)
    return cfg, sd, params, x


@pytest.mark.parametrize("quant", [None, False],
                         ids=["xla_parity", "flashflat_fast"])
def test_twelve_heads_fp32_taps_match(quant):
    """The parity config's einsum attention and the fast config's flat
    flash attention (B6's plain twin on the CPU) at twelve heads, fp32 on
    both sides."""
    base, sd, params, x = _twelve_heads()
    cfg = base if quant is None else fast_serving(base, quant)
    assert cfg.vit.attn_impl == ("xla" if quant is None else "flashflat")
    ref, _ = _taps(cfg.vit, jnp.float32, params, x)
    got, _, vit = _port_taps(cfg.vit, torch.float32, sd, x)
    assert vit.blocks[0].attn.flat == (quant is not None)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=TAPS_TOL, atol=TAPS_TOL)


def test_twelve_heads_int8_flashlnq_taps_within_bound():
    """`fast_serving(..., 'static')` at twelve heads: LN 1 + int8 qkv +
    attention + the output codes (B2's plain twin, six head pairs) and
    LN 2 + quantize (B3's plain twin) on the reference's quantized tree,
    bf16 taps by the d_port <= 2 d_ref rule (d_ref: JAX bf16 vs JAX fp32
    on the same tree)."""
    from lseg_tpu.ops.quant import quantize_tree as j_quantize_tree

    base, _, params, x = _twelve_heads()
    cfg = fast_serving(base, "static")
    assert cfg.vit.attn_impl == "flashlnq"
    pq = jax.tree_util.tree_map(np.asarray, j_quantize_tree(params))
    sd = {k[len("vit."):]: t for k, t in from_jax_variables(
        {"params": {"vit": pq}}).items()}
    ref_bf16, _ = _taps(cfg.vit, jnp.bfloat16, pq, x)
    ref_fp32, _ = _taps(cfg.vit, jnp.float32, pq, x)
    got, _, vit = _port_taps(cfg.vit, torch.bfloat16, sd, x)
    assert vit.blocks[0].attn.ln_fused and vit.blocks[0].ln_quant
    for i, (g, rb, rf) in enumerate(zip(got, ref_bf16, ref_fp32)):
        assert_bf16_bound(g, rb, rf, f"tap {i}")


@pytest.mark.parametrize("width", [640, 768])
def test_text_tower_at_rn50x_widths(width):
    """The CLIP text tower at RN50x4's width (640, ten heads) and
    RN50x16's (768, twelve heads): fp32 features as the reference's, to
    the tolerance of tests/test_torch_text.py."""
    from lseg_tpu.models.clip_text import CLIPTextEncoder as JText
    from lseg_tpu_torch.models.clip_text import CLIPTextEncoder
    from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer

    tc = tiny_text_config(width)
    tokens = ClipBPETokenizer.for_tests(tc.context_length)(
        ["the cat", "dog", "other", "grass and stone", "plant"])
    v = perturb(jax.jit(JText(tc).init)(jax.random.PRNGKey(0),
                                        jnp.asarray(tokens)))
    ref = f32(jax.jit(JText(tc).apply)(v, jnp.asarray(tokens)))
    enc = CLIPTextEncoder(tc)
    enc.load_state_dict(from_jax_text_params(v["params"]), strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(tokens)).numpy()
    assert got.shape == (5, width)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("option,depth", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_head_blocks_through_lseg_and_make_predictor(option, depth):
    """arch_option 1 (bottleneck) and 2 (depthwise) at block_depth 1 and 2
    (depth - 1 blocks with the activation, one without): the fp32 logits
    as the reference's, and `make_predictor`'s labels (its full-forward
    branch) as the reference predictor's, which is the argmax of those
    logits (`lseg_tpu/engine/serve.py:52-56`); near ties allowed."""
    cfg, x, txt, v, sd = _case(f"arch{option}")
    cfg = dataclasses.replace(cfg, block_depth=depth)
    ref = f32(_jax(cfg, jnp.float32, v, x, txt))
    model = _port(cfg, sd)
    applied = []
    model.head_block.register_forward_hook(
        lambda mod, args, out: applied.append(1))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(txt))
    assert len(applied) == max(depth, 1)
    dev = float(np.max(np.abs(got.numpy() - ref)))
    assert dev <= FP32_LOGITS_ATOL, dev
    labels = make_predictor(model)(x, txt)
    assert labels.dtype == torch.int32 and labels.shape == ref.shape[:3]
    agree = float(np.mean(labels.numpy() == ref.argmax(-1)))
    assert agree >= 0.99, agree


@pytest.mark.parametrize("option", [1, 2])
def test_head_blocks_exclude_the_fused_heads(option):
    """An int8 fast config with a head block never takes the fused heads
    (B4, B5, B14), in any output mode: the reference's gate
    (`lseg_tpu/models/lseg.py:158`)."""
    from lseg_tpu_torch.ops.quant import quantize_tree

    for head in ("lowres", True, "wup"):
        cfg = dataclasses.replace(
            fast_serving(_arch(option), "static_cal"), head_fused=head)
        fp32 = random_init_(LSegNet(dataclasses.replace(
            cfg, decoder_quant=False, vit=_arch(option).vit)),
            torch.Generator().manual_seed(0))
        model = LSegNet(cfg, torch.bfloat16).eval()
        model.load_state_dict(quantize_tree(
            fp32.state_dict(), decoder=True, act_scale=True,
            mlp_act_scale=cfg.vit.mlp_act_cal))
        fused = []
        for name in ("_fused_head", "_fused_argmax_head", "_fused_wup_head"):
            setattr(model, name, lambda *a, name=name: fused.append(name))
        x, txt = inputs(1, out_c=cfg.out_c)
        with torch.no_grad():
            for kw in ({}, {"return_argmax": True},
                       {"return_halfres": True}):
                out = model(torch.from_numpy(x), torch.from_numpy(txt), **kw)
                assert isinstance(out, torch.Tensor)
        assert fused == [], (head, fused)


def test_resnet_train_mode_batch_statistics():
    """`.train()` normalizes with the batch statistics in the ResNet and
    the decoder and updates the running statistics as the reference's
    `train=True` forward updates its `batch_stats`."""
    from lseg_tpu.models.lseg import LSegNet as JNet

    cfg, x, txt, v, sd = _case("resnet")
    ref, upd = jax.jit(lambda v, a, b: JNet(cfg).apply(
        v, a, b, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x), jnp.asarray(txt))
    model = _port(cfg, sd).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(txt))
    dev = float(np.max(np.abs(got.numpy() - f32(ref))))
    assert dev <= FP32_LOGITS_ATOL, dev
    want = from_jax_variables({"params": v["params"],
                               "batch_stats": jax.tree_util.tree_map(
                                   np.asarray, upd["batch_stats"])})
    state = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert any(k.startswith("resnet.") for k in stats)
    for k in stats:
        np.testing.assert_allclose(state[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_resnet_static_cal_matches_jax():
    """`fast_serving(tiny_rn_config(), 'static_cal')`, which sets no ViT
    knob: the reference's quantized tree calibrated in JAX; the port takes
    the same branches (the lowres B4 head, unnormalized at H/4, in the
    argmax call; B4 with the norm at H/2 for the half-res logits; head1
    unfused in `make_predictor`), with the half-res logits by the d_port
    <= 2 d_ref rule and the batch-1 labels as in
    tests/test_torch_lseg_int8.py."""
    from lseg_tpu.models.lseg import LSegNet as JNet
    from lseg_tpu.ops.quant import calibrate_act_scales as j_calibrate
    from lseg_tpu.ops.quant import quantize_tree as j_quantize_tree

    base, x, txt, v, _ = _case("resnet")
    cfg = fast_serving(base, "static_cal")
    assert cfg.vit is None and cfg.head_fused == "lowres"
    vq = dict(v)
    vq["params"] = j_quantize_tree(v["params"], decoder=True,
                                   act_scale=True, mlp_act_scale=False)
    vq = jax.tree_util.tree_map(np.asarray, j_calibrate(
        JNet(cfg, dtype=jnp.bfloat16), vq, jnp.asarray(x), None))
    model = _port(cfg, from_jax_variables(vq), torch.bfloat16)
    calls = []
    model._fused_head = (lambda f: lambda p, t, normalize: calls.append(
        (tuple(p.shape[1:3]), normalize)) or f(p, t, normalize))(
        model._fused_head)
    with torch.no_grad():
        half = model(torch.from_numpy(x), torch.from_numpy(txt),
                     return_halfres=True)
        labels = model(torch.from_numpy(x), torch.from_numpy(txt),
                       return_argmax=True)
    assert calls == [((32, 48), True), ((16, 24), False)]
    ref_bf16 = f32(_jax(cfg, jnp.bfloat16, vq, x, txt, return_halfres=True))
    ref_fp32 = f32(_jax(fp32_reference_of(cfg), jnp.float32, vq, x, txt,
                        return_halfres=True))
    assert_bf16_bound(half.float().numpy(), ref_bf16, ref_fp32,
                      "ResNet static_cal half-res logits")
    ref = np.concatenate([np.asarray(_jax(
        cfg, jnp.bfloat16, vq, x[i:i + 1], txt, return_argmax=True))
        for i in range(2)])
    agree = float(np.mean(labels.numpy() == ref))
    assert agree >= 0.985, agree
    calls.clear()
    pred = make_predictor(model)(x, txt)
    assert calls == [] and pred.shape == (2, 64, 96)


# ---- the kernels at the new widths, on the card ----

def _head1_args(dev, seed, n, h, w, c, e, k):
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (n, h, w, c)).astype(np.int8)
    w1q = rng.randint(-127, 128, (e, c)).astype(np.int8)
    s1 = (rng.rand(e) * 0.01 + 1e-3).astype(np.float32)
    b1 = (rng.randn(e) * 0.1).astype(np.float32)
    txt = rng.randn(k, e).astype(np.float32)
    return (torch.from_numpy(xq).to(dev), torch.tensor(0.02, device=dev),
            torch.from_numpy(w1q).to(dev), torch.from_numpy(s1).to(dev),
            torch.from_numpy(b1).to(dev), torch.from_numpy(txt).to(dev),
            1.0 / 0.07)


@pytest.mark.gpu
@pytest.mark.parametrize("e", [640, 768])
@pytest.mark.parametrize("shape,normalize", [((2, 60, 60), False),
                                             ((1, 120, 120), True)])
def test_b4_at_text_widths(cuda_device, e, shape, normalize):
    """B4 at RN50x4's and RN50x16's E (5 and 6 quarters of 128 head1
    channels a step) against K = 150 in both modes: within one bf16 ulp +
    1e-3 of the plain twin, and bit for bit the mma.sync B4 kernel's."""
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_fused,
        head1_correlate_fused_mma,
        head1_correlate_fused_plain,
    )

    args = _head1_args(cuda_device, e, *shape, 256, e, 150) + (normalize,)
    before = head1_correlate_fused.launches
    got = head1_correlate_fused(*args)
    ref = head1_correlate_fused_plain(*args).float()
    mma = head1_correlate_fused_mma(*args)
    torch.cuda.synchronize()
    assert head1_correlate_fused.launches == before + 1
    ulp = torch.exp2(torch.floor(torch.log2(
        ref.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)
    assert bool(((got.float() - ref).abs() <= ulp + 1e-3).all())
    assert torch.equal(got, mma)


@pytest.mark.gpu
@pytest.mark.parametrize("e", [640, 768])
def test_b14_at_text_widths(cuda_device, e):
    """B14 at E = 640 and 768 (H/2 rows of the 480 x 480 crop, K = 150):
    two ulps of the W-interp of |logits| + 1e-3 from the plain twin, and
    bit for bit the W-interp of B4's logits on the same inputs."""
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_fused,
        head1_correlate_fused_plain,
        head1_correlate_wup_fused,
        head1_correlate_wup_fused_plain,
        w_interp_bf16,
    )

    args = _head1_args(cuda_device, e + 1, 1, 24, 240, 256, e, 150)
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
@pytest.mark.parametrize("e", [640, 768])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_b10_at_text_widths(cuda_device, e, dt):
    """B10 in the streamed head's fp32 mode at E = 640 and 768 (bf16 and
    fp32 embeddings at H/2 of a 480 x 480 crop, K = 150), to the tolerance
    of tests/test_torch_heads.py."""
    from lseg_tpu_torch.ops.fused_correlate import (
        fused_correlate,
        fused_correlate_plain,
    )

    g = torch.Generator(device=cuda_device).manual_seed(e)
    x = torch.randn(1, 240, 240, e, device=cuda_device, generator=g).to(dt)
    t = torch.randn(150, e, device=cuda_device, generator=g)
    before = fused_correlate.launches
    got = fused_correlate(x, t)
    ref = fused_correlate_plain(x, t)
    torch.cuda.synchronize()
    assert fused_correlate.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_b2_b3_at_vitb32_tokens(cuda_device):
    """B2 (a cluster of six CTAs, one a head pair) and B3 at ViT-B's D =
    768 and ViT-B/32's T = 226 (1 + 15 x 15 at 480 x 480), against their
    plain twins within chip_smoke.py's gates: B2's dequantized outputs
    within 2e-2 of max|plain|; B3's codes one level apart at most, 99.9%
    equal, its row scales to 1e-5."""
    from lseg_tpu_torch.ops.flash_attention import (
        flash_attention_ln_qkv_fused_q8,
        flash_attention_ln_qkv_fused_q8_plain,
    )
    from lseg_tpu_torch.ops.ln_quant import (
        ln_quantize_rows,
        ln_quantize_rows_plain,
    )

    d, t, dev = 768, 226, cuda_device
    rng = np.random.RandomState(226)
    x = torch.from_numpy(rng.randn(2, t, d).astype(np.float32) * 0.3
                         + 0.05).to(dev, torch.bfloat16)
    gam = torch.from_numpy((1 + 0.1 * rng.randn(d)).astype(np.float32)
                           ).to(dev)
    bet = torch.from_numpy((0.1 * rng.randn(d)).astype(np.float32)).to(dev)
    wq = torch.from_numpy(rng.randint(-127, 128, (3 * d, d)).astype(
        np.int8)).to(dev)
    # phase 2's weight scales: scores of a few units, as a model's (at
    # ~1e-2 nearly every softmax row is one-hot and B3's permitted
    # bin-edge code flips move near-tied rows by several percent at every
    # width: `python -m lseg_tpu_torch.engine.b2_score_regimes`)
    sw = torch.from_numpy((rng.rand(3 * d) * 1e-3).astype(np.float32)
                          ).to(dev)
    bias = torch.from_numpy((rng.randn(3 * d) * 0.05).astype(np.float32)
                            ).to(dev)
    args = (x, gam, bet, wq, sw, bias, 12, 64 ** -0.5)
    before = (flash_attention_ln_qkv_fused_q8.launches,
              ln_quantize_rows.launches)
    oq, os_ = flash_attention_ln_qkv_fused_q8(*args)
    pq, ps = flash_attention_ln_qkv_fused_q8_plain(*args)
    q, s = ln_quantize_rows(x, gam, bet)
    qp, sp = ln_quantize_rows_plain(x, gam, bet)
    torch.cuda.synchronize()
    assert (flash_attention_ln_qkv_fused_q8.launches,
            ln_quantize_rows.launches) == (before[0] + 1, before[1] + 1)
    ref = pq.float() * ps
    err = float((oq.float() * os_ - ref).abs().max() / ref.abs().max())
    assert err < 2e-2, err
    diff = (q.int() - qp.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 0).float().mean()) >= 0.999
    torch.testing.assert_close(s, sp, rtol=1e-5, atol=0)
