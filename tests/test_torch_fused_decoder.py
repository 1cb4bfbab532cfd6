"""The fused int8 decoder (`decoder_fused_rcu` + `decoder_fused_tail` on
the `static_cal` serving config) against the JAX package's: the plain twins
of kernels B18 (`fused_rcu`) and B19 (`fused_upsample_outconv`, bf16 and
int8 out) and `fold_bn_affine` against the Pallas kernels in interpret
mode, the shape gates, the routing of both options (per call, under
calibration, 'static' and training, and refinenet1's int8 hand-off to the
fused head), the tiny model on carried-across JAX-calibrated trees with and
without `decoder_conv_first`, calibration with the options on and off, and
the `gpu`-marked checks of the CUDA kernels against their plain versions.
The flax models of the JAX package are imported inside the tests that use
them: the card machine has JAX but no flax."""

import dataclasses
import functools

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
from lseg_tpu.ops import pallas_decoder as j_decoder
from lseg_tpu.ops import pallas_qconv as j_qconv
from lseg_tpu.ops.resize import _interp_matrix as j_interp_matrix
from lseg_tpu.testing import tiny_vit_config
from lseg_tpu_torch.config import BACKBONES
from lseg_tpu_torch.models import blocks
from lseg_tpu_torch.models.layers import random_init_
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.ops import decoder, qconv
from lseg_tpu_torch.ops.decoder import (
    fused_upsample_outconv,
    fused_upsample_outconv_plain,
)
from lseg_tpu_torch.ops.qconv import (
    fold_bn_affine,
    fused_rcu,
    fused_rcu_plain,
)
from lseg_tpu_torch.ops.quant import calibrate_act_scales
from lseg_tpu_torch.utils.convert import from_jax_variables

# Bit for bit is the aim: every product of the kernels' arithmetic is
# exact or rounded where the reference rounds it. XLA's CPU compiler may
# contract acc * d + e into one FMA, which the port rounds twice, so an
# output may sit one bf16 ulp (2^-7 of |ref| at most) or one int8 level
# away; through B18's requantized h such a level moves the conv2 sums of
# its neighbours by |w2| d2 <= 127 max|d2|. At least 99.9% of the outputs
# must be equal bit for bit.
BF16_ULP = 2.0 ** -7
MIN_EQUAL = 0.999


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16(a):
    """numpy fp32 values on the bf16 grid."""
    return f32(jnp.asarray(a, jnp.bfloat16))


def _assert_near_exact(got, ref, atol, what):
    equal = float(np.mean(got == ref))
    err = np.abs(got - ref)
    bad = int((err > atol + BF16_ULP * np.abs(ref)).sum())
    print(f"{what}: equal {equal:.6f}, max |port - jax| {err.max():.4g}, "
          f"over tolerance {bad}")
    assert bad == 0 and equal >= MIN_EQUAL, (what, equal, float(err.max()))


# ---- B18: the fused ResidualConvUnit ----

def _rcu_inputs(seed, n, h, w, c, use_bn=True):
    """bf16 x with a graded magnitude, int8 HWIO kernels, and BatchNorm
    statistics (or a conv bias) whose positive shift makes conv1 of the
    zero-padded border non-zero, so conv2's edge padding counts."""
    rng = np.random.RandomState(seed)
    x = _bf16(rng.randn(n, h, w, c) * (1.0 + np.arange(c) / c))
    k1 = rng.randint(-127, 128, (3, 3, c, c)).astype(np.int8)
    k2 = rng.randint(-127, 128, (3, 3, c, c)).astype(np.int8)
    sw1 = (rng.rand(c) * 2e-3 + 1e-4).astype(np.float32)
    sw2 = (rng.rand(c) * 2e-3 + 1e-4).astype(np.float32)

    def bn():
        if not use_bn:
            return (None,) * 4
        return ((rng.rand(c) + 0.5).astype(np.float32),
                (rng.rand(c) * 0.5 + 0.1).astype(np.float32),
                (rng.randn(c) * 0.1).astype(np.float32),
                (rng.rand(c) + 0.5).astype(np.float32))

    b1 = None if use_bn else (rng.rand(c) * 0.5 + 0.1).astype(np.float32)
    b2 = None if use_bn else (rng.randn(c) * 0.1).astype(np.float32)
    a1 = np.float32(np.abs(np.maximum(x, 0)).max())
    a2 = np.float32(a1 * 4.0)
    return x, (k1, sw1, b1, bn(), a1), (k2, sw2, b2, bn(), a2)


def _jax_rcu(x, conv1, conv2, rows):
    ops = []
    for k, sw, b, stats, a in (conv1, conv2):
        d, e = j_qconv.fold_bn_affine(
            jnp.float32(a) / 127.0, jnp.asarray(sw),
            *[None if s is None else jnp.asarray(s) for s in stats],
            conv_bias=None if b is None else jnp.asarray(b))
        ops += [jnp.asarray(k), d, e, jnp.float32(127.0) / jnp.float32(a)]
    out = j_qconv.fused_rcu(jnp.asarray(x, jnp.bfloat16), *ops, rows=rows,
                            interpret=True)
    return f32(out), [np.asarray(o) for o in ops]


def _port_rcu_ops(x, conv1, conv2):
    """The port's own operands of `_rcu_inputs`: kernels in the (C, 9C)
    layout, `fold_bn_affine`, the inverse scales."""
    ops = []
    for k, sw, b, stats, a in (conv1, conv2):
        d, e = fold_bn_affine(torch.tensor(a) / 127.0, _t(sw),
                              *[None if s is None else _t(s) for s in stats],
                              conv_bias=None if b is None else _t(b))
        c = k.shape[-1]
        ops += [_t(np.ascontiguousarray(k.reshape(9 * c, c).T)), d, e,
                127.0 / torch.tensor(a)]
    return (_t(x).bfloat16(), *ops)


def _port_rcu_args(x, jops):
    k1, d1, e1, s1, k2, d2, e2, s2 = jops
    c = k1.shape[-1]
    w = [_t(np.ascontiguousarray(k.reshape(9 * c, c).T)) for k in (k1, k2)]
    return (_t(x).bfloat16(), w[0], _t(d1), _t(e1), _t(s1), w[1], _t(d2),
            _t(e2), _t(s2))


@pytest.mark.parametrize("shape,rows,use_bn", [
    ((2, 16, 16, 128), 8, True),      # two bands: an inner halo
    ((1, 15, 15, 128), None, True),   # three bands of 5, W not a multiple of 8
    ((2, 16, 16, 128), 8, False),     # no BN: the conv bias folded
])
def test_fused_rcu_plain_matches_pallas(shape, rows, use_bn):
    x, conv1, conv2 = _rcu_inputs(sum(shape), *shape, use_bn=use_bn)
    ref, jops = _jax_rcu(x, conv1, conv2, rows)
    args = _port_rcu_args(x, jops)
    got = fused_rcu_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    _assert_near_exact(got.float().numpy(), ref,
                       127.0 * float(np.abs(jops[5]).max()),
                       f"fused_rcu {shape} rows={rows} bn={use_bn}")
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(fused_rcu(*args).float().numpy(),
                                  got.float().numpy())


def test_fused_rcu_edge_padding_is_conv2s_own():
    """conv2's input outside the image is its zero padding: the plain twin
    differs from conv1 of the padded border on the outermost ring only,
    where this input makes that ring matter."""
    x, conv1, conv2 = _rcu_inputs(4, 1, 15, 15, 128)
    _, jops = _jax_rcu(x, conv1, conv2, None)
    args = list(_port_rcu_args(x, jops))
    got = fused_rcu_plain(*args).float()
    # conv1 of the padded border: run the twin on the image padded by one
    # pixel of zeros (q1 = 0 there) and crop
    padded = torch.nn.functional.pad(args[0], (0, 0, 1, 1, 1, 1))
    wrong = fused_rcu_plain(padded, *args[1:]).float()[:, 1:-1, 1:-1]
    differs = (got != wrong).any(dim=-1)[0]
    assert bool(differs[0].any() or differs[-1].any()
                or differs[:, 0].any() or differs[:, -1].any())
    assert not bool(differs[1:-1, 1:-1].any())


@pytest.mark.parametrize("case", ["bn", "bias", "bn+bias"])
def test_fold_bn_affine_matches_jax(case):
    rng = np.random.RandomState(11)
    c = 64
    sx = np.float32(0.37)
    sw = (rng.rand(c) * 1e-3).astype(np.float32)
    stats = [(rng.rand(c) + 0.5).astype(np.float32),
             rng.randn(c).astype(np.float32),
             rng.randn(c).astype(np.float32),
             (rng.rand(c) + 0.1).astype(np.float32)]
    if case == "bias":
        stats = [None] * 4
    bias = None if case == "bn" else rng.randn(c).astype(np.float32)
    jd, je = j_qconv.fold_bn_affine(
        jnp.float32(sx), jnp.asarray(sw),
        *[None if s is None else jnp.asarray(s) for s in stats],
        conv_bias=None if bias is None else jnp.asarray(bias))
    d, e = fold_bn_affine(
        torch.tensor(sx), _t(sw), *[None if s is None else _t(s)
                                    for s in stats],
        conv_bias=None if bias is None else _t(bias))
    assert d.dtype == e.dtype == torch.float32
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-6,
                               atol=1e-7)


# ---- B19: the fused upsample + quantize + out_conv tail ----

def _tail_inputs(seed, n, h, w, c, co):
    rng = np.random.RandomState(seed)
    x = _bf16(rng.randn(n, h, w, c))
    wq = rng.randint(-127, 128, (1, 1, c, co)).astype(np.int8)
    sw = (rng.rand(co) * 0.01 + 1e-3).astype(np.float32)
    b = (rng.randn(co) * 0.1).astype(np.float32)
    s_in = np.float32(np.float32(np.abs(x).max()) / np.float32(127.0))
    return x, wq, sw, b, s_in


@pytest.mark.parametrize("shape,out_int8", [
    ((2, 20, 16, 128), False), ((2, 20, 16, 128), True),
    ((1, 30, 8, 128), False),  # three bands of 10 in the reference
    ((1, 30, 8, 128), True)])
def test_fused_upsample_outconv_plain_matches_pallas(shape, out_int8):
    x, wq, sw, b, s_in = _tail_inputs(sum(shape), *shape, 128)
    s_out = np.float32(0.05) if out_int8 else None
    ref = j_decoder.fused_upsample_outconv(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq), jnp.asarray(sw),
        jnp.asarray(b), jnp.float32(s_in),
        out_scale=None if s_out is None else jnp.float32(s_out),
        out_int8=out_int8, interpret=True)
    args = (_t(x).bfloat16(), _t(np.ascontiguousarray(wq[0, 0].T)), _t(sw),
            _t(b), torch.tensor(s_in),
            None if s_out is None else torch.tensor(s_out))
    got = fused_upsample_outconv_plain(*args)
    want = torch.int8 if out_int8 else torch.bfloat16
    assert got.dtype == want and got.shape == ref.shape
    ref = np.asarray(ref).astype(np.float32)
    # an int8 code one level off is 1.0 apart here
    _assert_near_exact(got.float().numpy(), ref, 1.0 if out_int8 else 0.0,
                       f"fused_upsample_outconv {shape} int8={out_int8}")
    np.testing.assert_array_equal(
        fused_upsample_outconv(*args).float().numpy(), got.float().numpy())


def test_tail_taps_round_each_tap_to_bf16():
    """The H and W taps are the align-corners operator's rows with each
    entry rounded to bf16 on its own, as the reference builds them
    (`pallas_decoder.py:154-163`); 1 - bf16(f) would differ."""
    one_minus_differs = False
    for n in (15, 30, 60, 120):
        lo, t0, t1 = decoder.interp_taps(n, torch.device("cpu")).numpy()
        a = j_interp_matrix(n, 2 * n, True)
        ab = a.astype(jnp.bfloat16).astype(np.float32)
        ho = np.argmax(a > 0, axis=1)
        idx = np.arange(2 * n)
        hi = np.minimum(ho + 1, n - 1)
        np.testing.assert_array_equal(lo, ho)
        np.testing.assert_array_equal(t0, ab[idx, ho])
        np.testing.assert_array_equal(
            t1, np.where(hi > ho, ab[idx, hi], 0.0).astype(np.float32))
        one_minus_differs |= bool(np.any(t0 != _bf16(1.0 - t1)))
    assert one_minus_differs
    taps = decoder.interp_taps(60, torch.device("cpu"))
    assert taps is decoder.interp_taps(60, torch.device("cpu"))


# ---- the shape gates ----

_SIZES = (1, 2, 3, 4, 5, 7, 8, 12, 15, 16, 30, 32, 60, 64, 120, 128, 240)


@pytest.mark.parametrize("gate", ["rcu_fusable", "tail_fusable", "_pick_rows"])
def test_gates_equal_reference(gate):
    for h in _SIZES:
        if gate == "_pick_rows":
            assert qconv._pick_rows(h) == j_qconv._pick_rows(h), h
            continue
        for w in _SIZES:
            for c in (64, 128, 192, 256):
                if gate == "rcu_fusable":
                    assert qconv.rcu_fusable(h, w, c) == \
                        j_qconv.rcu_fusable(h, w, c), (h, w, c)
                else:
                    for co in (128, 200, 256):
                        assert decoder.tail_fusable(h, w, c, co) == \
                            j_decoder.tail_fusable(h, w, c, co), (h, w, c, co)


# ---- the model builds on every ViT config ----

@pytest.mark.parametrize("name", [n for n in BACKBONES if "resnet" not in n])
def test_lseg_builds_with_the_fused_decoder(name):
    """`LSegNet` takes either option, or both, on every ViT backbone (on
    the meta device: no weights are allocated); each RCU and fusion block
    carries its option."""
    base = fast_serving(BACKBONES[name], "static_cal")
    for rcu, tail in ((True, False), (False, True), (True, True)):
        cfg = dataclasses.replace(base, decoder_fused_rcu=rcu,
                                  decoder_fused_tail=tail)
        model = LSegNet(cfg, torch.bfloat16, device="meta")
        for i in range(1, 5):
            blk = getattr(model, f"refinenet{i}")
            assert blk.tail_fused == tail and blk.rcu2.fused == rcu


# ---- routing on the tiny model ----

def routing_config(**kw):
    """The config of the reference's fused-tail model test
    (`tests/test_pallas_ops.py:611-613`) with both fused options on."""
    return tiny_vit_config(features=128, out_c=128, head_dtype="bfloat16",
                           decoder_quant="static_cal", head_fused=True,
                           decoder_fused_rcu=True, decoder_fused_tail=True,
                           **kw)


def _counting(monkeypatch):
    """Count calls of the fused plain twins the blocks reach on the CPU,
    and the dtype of every tail's result."""
    calls = {"rcu": 0, "tail": 0, "tail_int8": 0}

    def wrap(key, fn):
        def counted(*a, **k):
            out = fn(*a, **k)
            calls[key] += 1
            if key == "tail" and out.dtype == torch.int8:
                calls["tail_int8"] += 1
            return out
        return counted

    monkeypatch.setattr(blocks, "fused_rcu", wrap("rcu", qconv.fused_rcu))
    monkeypatch.setattr(blocks, "fused_upsample_outconv",
                        wrap("tail", decoder.fused_upsample_outconv))
    return calls


def _tiny_model(cfg, seed=0):
    model = random_init_(LSegNet(cfg, torch.bfloat16),
                         torch.Generator().manual_seed(seed))
    for name, p in model.named_parameters():   # non-degenerate int8 params
        if name.endswith("act_scale"):
            p.data.fill_(4.0)
        elif name.endswith("weight_q"):
            p.data.copy_(torch.randint(-127, 128, p.shape, dtype=torch.int8,
                                       generator=torch.Generator()
                                       .manual_seed(len(name))))
        elif name.endswith(".scale") and p.dim() == 1:
            p.data.fill_(1e-3)
    return model.eval()


# grid 4 x 4 at 64 x 64: refinenet4 2 x 2, refinenet3 4 x 4, refinenet2
# 8 x 8, refinenet1 16 x 16 (then the tail to 32 x 32). Fused RCUs: the two
# of refinenet2 and of refinenet1 (refinenet3's 4 x 4 has W < 8). Fused
# tails: refinenet3 (2W = 8), refinenet2 and refinenet1; refinenet4's
# 2W = 4 is no multiple of 8.
ROUTES = {"argmax head_fused": (4, 3, 1),
          "logits head_fused": (4, 3, 1),
          "conv_first": (4, 2, 0),
          "no text": (4, 3, 0)}


@pytest.mark.parametrize("case", list(ROUTES))
def test_fused_decoder_routes_per_call(monkeypatch, case):
    """The plain twins of B18 and B19 run the reference's number of times
    per call; refinenet1 returns int8 exactly when the fused head hands it
    head1's grid and its tail is fused (not under `decoder_conv_first`,
    not without text)."""
    cfg = routing_config(decoder_conv_first=case == "conv_first")
    model = _tiny_model(cfg)
    calls = _counting(monkeypatch)
    x, txt = inputs(0, n=1, h=64, w=64, k=3, out_c=128)
    kw = {"return_argmax": True} if "argmax" in case else {}
    with torch.no_grad():
        out = model(_t(x), None if case == "no text" else _t(txt), **kw)
    assert (calls["rcu"], calls["tail"], calls["tail_int8"]) == ROUTES[case]
    if "argmax" in case:
        assert out.shape == (1, 64, 64) and out.dtype == torch.int32


@pytest.mark.parametrize("mode", ["calibration", "static", "train"])
def test_fused_decoder_routes_off(monkeypatch, mode):
    """No fused twin under calibration (the convs record their input
    ranges) or under 'static' (dynamic scales); in training the RCU twin
    stays off and the tail follows its gate, which has no training term in
    the reference (`blocks.py:346-347`)."""
    cfg = routing_config()
    if mode == "static":
        cfg = dataclasses.replace(cfg, decoder_quant="static")
    model = _tiny_model(cfg)
    calls = _counting(monkeypatch)
    x, txt = inputs(0, n=1, h=64, w=64, k=3, out_c=128)
    with torch.no_grad():
        if mode == "calibration":
            calibrate_act_scales(model, _t(x), None)
        elif mode == "static":
            model(_t(x), _t(txt))
        else:
            model.train()
            model(_t(x), _t(txt))
    want = (0, 3, 1) if mode == "train" else (0, 0, 0)
    assert (calls["rcu"], calls["tail"], calls["tail_int8"]) == want


def test_refinenet1_hands_int8_only_when_fusable():
    """Called alone, the block returns head1-grid codes exactly when
    `out_int8_scale` is handed and its tail takes B19: bf16 without the
    scale, and bf16 at a width whose upsample is no multiple of 8."""
    model = _tiny_model(routing_config())
    blk = model.refinenet1
    rng = np.random.RandomState(2)
    scale = torch.tensor(0.02)
    for w, handed, want in ((16, True, torch.int8),
                            (16, False, torch.bfloat16),
                            (6, True, torch.bfloat16)):
        x = _t(rng.randn(1, 8, w, 128).astype(np.float32)).bfloat16()
        skip = _t(rng.randn(1, 8, w, 128).astype(np.float32)).bfloat16()
        with torch.no_grad():
            out = blk(x, skip, out_int8_scale=scale if handed else None)
        assert out.dtype == want and out.shape == (1, 16, 2 * w, 128), (w,)


def test_rcu_operands_are_prepared_once():
    """The fused RCU's weights in the kernel layout and its folded
    affines are made once per module state: a second call reuses them, a
    `load_state_dict` remakes them."""
    model = _tiny_model(routing_config())
    rcu = model.refinenet1.rcu2
    first = rcu._kernel_operands()
    assert rcu._kernel_operands() is first
    state = {k: v.clone() for k, v in rcu.state_dict().items()}
    state["conv1.act_scale"] = torch.tensor(8.0)
    rcu.load_state_dict(state)
    again = rcu._kernel_operands()
    assert again is not first
    assert float(again[3]) == pytest.approx(127.0 / 8.0)
    w = rcu.conv1.weight_q
    np.testing.assert_array_equal(
        first[0].reshape(128, 3, 3, 128).permute(0, 3, 1, 2).numpy(),
        w.numpy())


# ---- the tiny model on carried-across JAX-calibrated trees ----

def _base():
    return dataclasses.replace(tiny_parity_config(), features=128, out_c=128)


def handoff_config(conv_first=False):
    """The smoke's 3i path on the tiny model (the fused decoder, the
    `head_fused=True` head and, without `decoder_conv_first`, refinenet1's
    int8 hand-off), or with `conv_first` its 3h path on `fast_serving`'s
    lowres head."""
    cfg = dataclasses.replace(fast_serving(_base(), "static_cal"),
                              decoder_fused_rcu=True, decoder_fused_tail=True)
    if conv_first:
        return cfg
    return dataclasses.replace(cfg, head_fused=True, decoder_conv_first=False)


# (2, 64, 128): grid 4 x 8, so refinenet3 (4 x 8) takes B18 and every
# refinenet's tail (2W = 8, 16, 32, 64) takes B19
X_SHAPE = dict(n=2, h=64, w=128, out_c=128)


@functools.lru_cache(maxsize=None)
def _jitted(cfg, dtype, kw):
    from lseg_tpu.models.lseg import LSegNet as JNet

    return jax.jit(lambda v, *a: JNet(cfg, dtype=dtype).apply(
        v, *a, **dict(kw)))


def _jax_apply(cfg, dtype, v, *args, **kw):
    fn = _jitted(cfg, dtype, tuple(sorted(kw.items())))
    return fn(v, *[jnp.asarray(a) for a in args])


@functools.lru_cache(maxsize=None)
def _fp32_variables():
    x, txt = inputs(0, **X_SHAPE)
    return x, txt, jax_lseg_variables(_base(), x, txt)


@functools.lru_cache(maxsize=None)
def _carry(conv_first):
    """A perturbed tiny head_dim-64 tree, quantized and calibrated in JAX
    on the fused config, and its conversion."""
    from lseg_tpu.models.lseg import LSegNet as JNet
    from lseg_tpu.ops.quant import calibrate_act_scales as j_calibrate
    from lseg_tpu.ops.quant import quantize_tree as j_quantize_tree

    cfg = handoff_config(conv_first)
    x, txt, v = _fp32_variables()
    vq = dict(v)
    vq["params"] = j_quantize_tree(v["params"], decoder=True, act_scale=True)
    vq = _np_tree(j_calibrate(JNet(cfg, dtype=jnp.bfloat16), vq,
                              jnp.asarray(x), None))
    return x, txt, v, cfg, vq, from_jax_variables(vq)


def _port(cfg, sd):
    model = LSegNet(cfg, dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True)
    return model


@pytest.mark.parametrize("conv_first", [False, True])
def test_fused_decoder_tree_covers_every_leaf(conv_first):
    """`from_jax_variables` needs no change: the reference's fused paths
    declare the unfused leaves (`QConvParams`, `_BNStats`)."""
    *_, cfg, vq, sd = _carry(conv_first)
    model = _port(cfg, sd)
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(vq))
    assert sum(t.numel() for t in model.state_dict().values()) == n_jax
    state = model.state_dict()
    assert state["refinenet1.rcu2.conv1.weight_q"].shape == (128, 128, 3, 3)
    assert state["refinenet1.rcu2.bn2.running_var"].shape == (128,)
    assert float(state["refinenet1.out_conv.act_scale"]) != 1.0


@pytest.mark.parametrize("conv_first", [False, True])
def test_fused_decoder_halfres_logits_within_bf16_bound(conv_first):
    """B4's half-res logits (on refinenet1's int8 codes without
    `conv_first`) against JAX's on the same tree, by d_port <= 2 d_ref +
    0.05, d_ref = JAX bf16 vs JAX fp32. The fp32 program is the unfused
    decoder of `fast_serving` (the same function: the fused paths move no
    rounding point that fp32 has, and out_conv commutes with the
    upsample), one program for both trees."""
    x, txt, _, cfg, vq, sd = _carry(conv_first)
    ref_bf16 = f32(_jax_apply(cfg, jnp.bfloat16, vq, x, txt,
                              return_halfres=True))
    ref_fp32 = f32(_jax_apply(
        fp32_reference_of(fast_serving(_base(), "static_cal")), jnp.float32,
        vq, x, txt, return_halfres=True))
    with torch.no_grad():
        got = _port(cfg, sd)(_t(x), _t(txt), return_halfres=True)
    assert got.dtype == torch.bfloat16 and got.shape == ref_bf16.shape
    d_port, d_ref = assert_bf16_bound(got.float().numpy(), ref_bf16,
                                      ref_fp32, "fused decoder half-res")
    print(f"conv_first={conv_first}: d_port={d_port} d_ref={d_ref}")


@pytest.mark.parametrize("conv_first", [False, True])
def test_fused_decoder_argmax_matches_jitted_batch1(conv_first):
    """bench.py's call, `model(x, txt, return_argmax=True)`: B5 on
    refinenet1's int8 codes, or the lowres B4 head under `conv_first`,
    against the jitted batch-1 JAX program. Random-init margins are near
    ties (ROADMAP C), and this fixture (features 128, 64 x 128) has more of
    them than the other int8 fixtures: JAX's own fp32 program agrees with
    its bf16 one on 0.9705 (hand-off) and 0.9773 (conv_first) of the
    pixels, the port's unfused decoder with JAX's on 0.9766 and 0.9768,
    and the port measured 0.9736-0.9805. So the gate is 0.97; the label
    gate of the int8 grids on trained weights is the goldens'."""
    x, txt, _, cfg, vq, sd = _carry(conv_first)
    with torch.no_grad():
        got = _port(cfg, sd)(_t(x), _t(txt), return_argmax=True)
    assert got.dtype == torch.int32 and got.shape == (2, 64, 128)
    ref = np.concatenate([np.asarray(_jax_apply(
        cfg, jnp.bfloat16, vq, x[i:i + 1], txt, return_argmax=True))
        for i in range(2)])
    agree = float(np.mean(got.numpy() == ref))
    print(f"conv_first={conv_first}: labels vs JAX batch-1 {agree:.4f}")
    assert agree >= 0.97, agree


def test_calibration_ignores_the_fused_options():
    """The port's `calibrate_act_scales` runs the unfused decoder, so the
    options on and off give the same scales, and they are the reference's
    (calibrated in JAX on the fused config)."""
    x, _, _, cfg, _, sd = _carry(False)
    off = dataclasses.replace(cfg, decoder_fused_rcu=False,
                              decoder_fused_tail=False)
    scales = []
    for c in (cfg, off):
        model = _port(c, sd)
        calibrate_act_scales(model, _t(x), None)
        scales.append({k: float(v) for k, v in model.state_dict().items()
                       if k.endswith("act_scale")})
    assert scales[0] == scales[1]
    worst = max(abs(scales[0][k] - float(sd[k])) / float(sd[k])
                for k in scales[0])
    print(f"worst relative act_scale deviation from JAX's {worst:.3g}")
    assert worst <= 5e-2


def test_profile_serving_has_the_decoder_paths(monkeypatch, capsys):
    """`--path fused_decoder` and `--path int8_handoff` exist and, like
    every path, need a card."""
    from lseg_tpu_torch.engine import profile_serving

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for path in ("fused_decoder", "int8_handoff"):
        assert path in profile_serving.PATHS
        assert profile_serving.main(["--path", path]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def _wrong_inputs(kernel):
    if kernel == "fused_rcu":
        a = list(_port_rcu_ops(*_rcu_inputs(0, 1, 8, 8, 64)))
        return fused_rcu, a, [
            (1, a[1][:, :-1], ValueError, "w1q"),
            (2, a[2][:-1], ValueError, "d1"),
            (0, a[0].float(), TypeError, "x must be torch.bfloat16"),
            (5, a[5].float(), TypeError, "w2q must be torch.int8")]
    x, wq, sw, b, s_in = _tail_inputs(0, 1, 4, 4, 64, 128)
    a = [_t(x).bfloat16(), _t(np.ascontiguousarray(wq[0, 0].T)), _t(sw),
         _t(b), torch.tensor(s_in), torch.tensor(0.1)]
    return fused_upsample_outconv, a, [
        (1, a[1][:, :-1], ValueError, "wq"),
        (3, a[3][:-1], ValueError, "b"),
        (0, a[0].float(), TypeError, "x must be torch.bfloat16"),
        (5, a[5].double(), TypeError, "out_scale must be torch.float32")]


@pytest.mark.parametrize("kernel", ["fused_rcu", "fused_upsample_outconv"])
def test_decoder_wrappers_check_shapes_and_dtypes(kernel):
    fn, args, cases = _wrong_inputs(kernel)
    for i, bad, err, msg in cases:
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(err, match=msg):
            fn(*wrong)


# ---- the CUDA kernels against their plain versions (on the card) ----

def _on(dev, args):
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 120, 120, 256), (8, 15, 15, 256),
                                   (1, 16, 16, 128)])
def test_fused_rcu_kernel_matches_plain(cuda_device, shape):
    """Bit for bit: both sums are exact and every rounding step is the
    plain twin's."""
    args = _on(cuda_device, _port_rcu_ops(*_rcu_inputs(1, *shape)))
    before = fused_rcu.launches
    got = fused_rcu(*args)
    ref = fused_rcu_plain(*args)
    torch.cuda.synchronize()
    assert fused_rcu.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,out_int8", [((8, 60, 60, 256), False),
                                            ((2, 120, 120, 256), True),
                                            ((1, 20, 16, 128), True)])
def test_fused_upsample_outconv_kernel_matches_plain(cuda_device, shape,
                                                     out_int8):
    x, wq, sw, b, s_in = _tail_inputs(2, *shape, 256)
    args = _on(cuda_device, (_t(x).bfloat16(),
                             _t(np.ascontiguousarray(wq[0, 0].T)), _t(sw),
                             _t(b), torch.tensor(s_in),
                             torch.tensor(0.05) if out_int8 else None))
    before = fused_upsample_outconv.launches
    got = fused_upsample_outconv(*args)
    ref = fused_upsample_outconv_plain(*args)
    torch.cuda.synchronize()
    assert fused_upsample_outconv.launches == before + 1
    assert torch.equal(got, ref)
