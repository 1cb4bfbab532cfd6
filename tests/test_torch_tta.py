"""The port's multi-scale + flip TTA evaluator, single-scale evaluator,
per-class IoU and precise BN against the JAX package's and against the
literal torch/NumPy oracle of tests/test_tta.py, on one tiny model whose
weights cross from JAX (`from_jax_variables`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_tta import PROTO, _oracle
from torch_parity import inputs, jax_lseg_variables

from lseg_tpu.engine import tta as jtta
from lseg_tpu.engine.eval_single import SingleScaleEvaluator as JSingle
from lseg_tpu.engine.serve import make_logits_fn as j_logits_fn
from lseg_tpu.models.lseg import LSegNet as JNet
from lseg_tpu.ops.metrics import SegmentationMetric as JMetric
from lseg_tpu.testing import tiny_vit_config
from lseg_tpu.utils.precise_bn import update_bn_stats as j_update_bn_stats
from lseg_tpu_torch.engine import tta
from lseg_tpu_torch.engine.eval_single import SingleScaleEvaluator
from lseg_tpu_torch.engine.serve import make_logits_fn
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.ops.metrics import SegmentationMetric
from lseg_tpu_torch.utils.convert import from_jax_variables, to_jax_variables
from lseg_tpu_torch.utils.precise_bn import update_bn_stats

# Summed logits, port against the oracle on the port's own crop forwards:
# tests/test_tta.py's tolerance for JAX against the same oracle. Against
# JAX's evaluator (JAX's crop forwards): each of the up to 2 x 3 summed
# logits may carry the fp32 model tolerance of tests/test_torch_lseg.py,
# 1e-3.
ORACLE_TOL = 1e-4
JAX_SUM_ATOL = 6e-3


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_vit_config()
    x, txt = inputs(0, n=1, h=64, w=64, k=4, out_c=cfg.out_c)
    v = jax_lseg_variables(cfg, x, txt)
    model = LSegNet(cfg)
    model.load_state_dict(from_jax_variables(v))
    image = np.random.RandomState(0).randn(80, 100, 3).astype(np.float32)
    return (make_logits_fn(model), j_logits_fn(JNet(cfg), v), image,
            torch.from_numpy(txt), jnp.asarray(txt))


def _np_fn(logits_fn):
    """The oracle's `apply_fn(jnp images, txt)` over the port's forward."""
    def apply(images, txt):
        return logits_fn(torch.from_numpy(np.array(images)),
                         torch.from_numpy(np.array(txt))).numpy()
    return apply


@pytest.mark.parametrize("proto", [PROTO, jtta.ADE20K_PROTOCOL,
                                   jtta.CITYSCAPES_PROTOCOL])
@pytest.mark.parametrize("hw", [(80, 100), (64, 72), (40, 30), (512, 683),
                                (683, 512)])
def test_make_plan_equals_jax(proto, hw):
    mine = tta.TTAProtocol(proto.base_size, proto.crop_size, proto.scales,
                           proto.flip)
    got, ref = tta.make_plan(mine, *hw), jtta.make_plan(proto, *hw)
    assert (got.h, got.w, got.sizes, got.n_valid) == (
        ref.h, ref.w, ref.sizes, ref.n_valid)
    np.testing.assert_array_equal(got.crops, ref.crops)
    assert mine.canvas_sizes == proto.canvas_sizes
    assert mine.max_crops == proto.max_crops


def _port_proto(proto):
    return tta.TTAProtocol(proto.base_size, proto.crop_size, proto.scales,
                           proto.flip)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_tta_matches_oracle_and_jax(setup, as_tensor):
    """The image as a NumPy array (the dataset's) or as a tensor."""
    fn, jfn, image, txt, jtxt = setup
    ev = tta.MultiScaleEvaluator(fn, 4, _port_proto(PROTO))
    x = torch.from_numpy(image) if as_tensor else image
    ours = ev(x, txt, return_logits=True).numpy()
    oracle = _oracle(_np_fn(fn), image, txt.numpy(), PROTO, 4)
    np.testing.assert_allclose(ours, oracle, rtol=ORACLE_TOL,
                               atol=ORACLE_TOL)
    ref = jtta.MultiScaleEvaluator(jfn, 4, PROTO)(image, jtxt,
                                                  return_logits=True)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=JAX_SUM_ATOL)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * JAX_SUM_ATOL
    labels = ev(x, txt).numpy()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(labels[clear], ref.argmax(-1)[clear])


def test_device_pyramid_matches_host_and_jax():
    rng = np.random.RandomState(3)
    image = rng.randn(80, 100, 3).astype(np.float32)
    proto = _port_proto(PROTO)
    plan = tta.make_plan(proto, 80, 100)
    host = tta.build_pyramid(proto, image, plan)
    dev = tta.device_pyramid(proto, torch.from_numpy(image), plan).numpy()
    # fp32 sources on the device vs the host matrices' fp64 ones
    np.testing.assert_allclose(dev, host, rtol=1e-4, atol=1e-4)
    img = np.zeros((128, 128, 3), np.float32)
    img[:80, :100] = image
    jdev = np.asarray(jtta._make_pyramid_builder(PROTO)(
        jnp.asarray(img), jnp.asarray([80, 100], np.int32),
        jnp.asarray(plan.sizes, np.int32)))
    np.testing.assert_allclose(dev, jdev, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["no_flip", "smaller_than_crop"])
def test_tta_protocol_variants_match_oracle(setup, case):
    fn, _, image, txt, _ = setup
    if case == "no_flip":
        proto = jtta.TTAProtocol(base_size=72, crop_size=64,
                                 scales=(0.5, 1.0), flip=False)
    else:
        proto = jtta.TTAProtocol(base_size=48, crop_size=64,
                                 scales=(0.5, 1.0), flip=True)
        image = np.random.RandomState(3).randn(40, 30, 3).astype(
            np.float32)
    ev = tta.MultiScaleEvaluator(fn, 4, _port_proto(proto))
    ours = ev(image, txt, return_logits=True).numpy()
    ref = _oracle(_np_fn(fn), image, txt.numpy(), proto, 4)
    np.testing.assert_allclose(ours, ref, rtol=ORACLE_TOL, atol=ORACLE_TOL)


def test_tta_argmax_and_reuse_across_sizes(setup):
    fn, _, image, txt, _ = setup
    ev = tta.MultiScaleEvaluator(fn, 4, _port_proto(PROTO))
    pred = ev(image, txt)
    assert pred.shape == (80, 100) and pred.dtype == torch.int32
    image2 = np.random.RandomState(1).randn(64, 72, 3).astype(np.float32)
    assert ev(image2, txt).shape == (64, 72)
    logits = ev(image, txt, return_logits=True)
    assert torch.equal(torch.argmax(logits, -1).to(torch.int32), pred)
    assert set(ev._plans) == {(80, 100), (64, 72)}


def test_single_scale_evaluator_matches_jax(setup):
    fn, jfn, _, txt, jtxt = setup
    rng = np.random.RandomState(0)
    imgs = rng.randn(2, 64, 64, 3).astype(np.float32)
    tgts = rng.randint(-1, 4, (2, 64, 64)).astype(np.int32)
    ev = SingleScaleEvaluator(fn, 4, flip=True)
    jev = JSingle(jfn, 4, flip=True)
    ref = np.asarray(jev(jnp.asarray(imgs), jtxt))
    got = ev(torch.from_numpy(imgs), txt)
    assert got.shape == (2, 64, 64) and got.dtype == torch.int32
    assert (got.numpy() == ref).mean() > 0.999
    c, lab, inter, union = ev.metrics(imgs, tgts, txt)
    jc, jl, ji, ju = jev.metrics(jnp.asarray(imgs), jnp.asarray(tgts), jtxt)
    assert int(lab) == int(jl) == int((tgts != -1).sum())
    assert abs(int(c) - int(jc)) <= 0.001 * int(jl)
    np.testing.assert_allclose(inter.numpy(), np.asarray(ji),
                               atol=0.001 * int(jl))
    np.testing.assert_allclose(union.numpy(), np.asarray(ju),
                               atol=0.002 * int(jl))


def test_per_class_iou_matches_jax():
    rng = np.random.RandomState(5)
    mine, ref = SegmentationMetric(6), JMetric(6)
    for _ in range(3):
        logits = rng.randn(2, 16, 16, 6).astype(np.float32)
        tgt = rng.randint(-1, 6, (2, 16, 16)).astype(np.int32)
        mine.update(torch.from_numpy(logits), torch.from_numpy(tgt))
        ref.update(jnp.asarray(logits), jnp.asarray(tgt))
    np.testing.assert_array_equal(mine.per_class_iou(), ref.per_class_iou())
    assert mine.get() == ref.get()


def _bn_setup():
    cfg = tiny_vit_config()
    assert cfg.use_bn
    x, txt = inputs(2, n=1, h=64, w=64, k=4, out_c=cfg.out_c)
    v = jax_lseg_variables(cfg, x, txt)
    rng = np.random.RandomState(7)
    batches = [rng.randn(2, 64, 64, 3).astype(np.float32) for _ in range(3)]
    model = LSegNet(cfg)
    model.load_state_dict(from_jax_variables(v))
    update_bn_stats(model, (torch.from_numpy(b) for b in batches))
    assert not model.training
    return cfg, v, batches, model.state_dict()


def _bn_pairs(got, v, ref_stats):
    """(port mean, JAX mean, port var, JAX var) for each BatchNorm."""
    want = from_jax_variables({"params": v["params"],
                               "batch_stats": ref_stats})
    before = from_jax_variables(v)
    out = []
    for k in want:
        if k.endswith("running_mean"):
            b = k[:-len("mean")]
            assert not torch.equal(want[k], before[k])
            out.append((got[k].double(), want[k].double(),
                        got[b + "var"].double(), want[b + "var"].double()))
    assert len(out) == 7 * 2  # 7 RCUs, 2 BNs each
    return out


def test_update_bn_stats_recovery_matches_jax():
    """The moment recovery and the equal-weighted mean against JAX's on the
    same forwards (JAX's `update_bn_stats` driving the port's model):
    within 1e-6 relative."""
    cfg, v, batches, got = _bn_setup()
    model = LSegNet(cfg)

    def port_apply(variables, batch):
        model.load_state_dict(from_jax_variables(variables))
        model.train()
        with torch.no_grad():
            model(torch.from_numpy(np.asarray(batch)), None)
        return to_jax_variables(model.state_dict(),
                                cfg.vit.hooks)["batch_stats"]

    ref = j_update_bn_stats(port_apply, v, batches)
    for gm, wm, gv, wv in _bn_pairs(got, v, ref):
        np.testing.assert_allclose(gm, wm, rtol=1e-6, atol=0)
        np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=0)


def test_update_bn_stats_matches_jax():
    """Against JAX's precise BN on JAX's own forwards. The two fp32
    forwards differ at the BatchNorm inputs by up to ~2e-5 of their
    second moment (the decoder's convolutions in another order, then
    E[x^2] - E[x]^2), so: means within 1e-6 of the input's RMS
    sqrt(E[x^2]), variances within 5e-5 of E[x^2]."""
    cfg, v, batches, got = _bn_setup()
    jmodel = JNet(cfg)

    def bn_apply(variables, batch):
        _, mut = jmodel.apply(variables, batch, None, train=True,
                              mutable=["batch_stats"])
        return mut["batch_stats"]

    ref = j_update_bn_stats(bn_apply, v, (jnp.asarray(b) for b in batches))
    for gm, wm, gv, wv in _bn_pairs(got, v, ref):
        ex2 = wv + wm * wm
        assert float(((gm - wm).abs() / ex2.sqrt()).max()) <= 1e-6
        assert float(((gv - wv).abs() / ex2).max()) <= 5e-5
