"""The port's HSNet side-car against the JAX package's: the ResNet's
pre-relu taps, VGG16's taps and its torchvision key map, the multilayer
correlation, the center-pivot 4-D convolution at kernels 3 and 5 and
strides 1, 2 and 4, GroupNorm on a 6-D tensor, a building block, the HPN
learner, the whole HSNet with both backbones in fp32 and bf16 at a
non-square input (with and without `use_original_imgsize`), the n-shot
vote, one training step (the learner's gradients against `jax.grad`,
Adam against `optax.adam`, the frozen backbone) and the `hsnet_run` CLI
on the CPU.

Weights: the port's seeded init carried into the JAX tree and perturbed
(`torch_parity.perturb`), then carried back, so both packages run the
same numbers without JAX's op-by-op init; JAX applies are jitted once per
module. Tolerances, each beside the error measured on the CPU:
- fp32 modules and the whole fp32 model: |port - jax| <= 1e-5 + 1e-4
  |jax| (measured: logits 8.6e-7 at magnitude 0.39, the ResNet's taps
  4.2e-6 at 5.1, GroupNorm 1.4e-6, the HPN learner 7.2e-7); VGG16's taps,
  after up to 13 fp32 convs, within 1e-5 of max |jax| (measured 1.6e-6);
- bf16: `torch_parity.assert_bf16_bound` (measured d_port = one bf16 ulp,
  0.0059-0.0078, against d_ref 0.0070-0.0079);
- labels and votes: equal on every pixel where JAX's fp32 margin of every
  shot exceeds 1e-3, the margin rule keeping a reordered fp32 sum from
  flipping a tie;
- learner gradients: per tensor |g_port - g_jax| <= 1e-4 max |g_jax| +
  1e-7 (measured <= 2.2e-6 relative; layer4's first convs get no gradient
  in either package: its correlations clamp to 0 at this size);
- Adam: parameters after two steps within 1e-6 of optax's (measured
  2.4e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import assert_bf16_bound, perturb

from lseg_tpu.config import ResNetConfig as JResNetConfig
from lseg_tpu.models import hsnet as jhsnet
from lseg_tpu.models.resnet import ResNetBackbone as JResNet
from lseg_tpu.models.vgg import (
    VGG16Features as JVGG,
    convert_torchvision_vgg16,
)
from lseg_tpu.ops.losses import cross_entropy as j_cross_entropy
from lseg_tpu.ops.resize import resize_bilinear as j_resize
from lseg_tpu_torch import hsnet_run
from lseg_tpu_torch.config import ResNetConfig
from lseg_tpu_torch.models import hsnet
from lseg_tpu_torch.models.layers import GroupNorm, random_init_
from lseg_tpu_torch.models.resnet import ResNetBackbone
from lseg_tpu_torch.models.vgg import HSNET_VGG_TAPS, VGG16Features
from lseg_tpu_torch.utils.checkpoint_convert import (
    apply_key_map,
    torchvision_vgg16_key_map,
)
from lseg_tpu_torch.utils.convert import from_jax_variables, to_jax_variables

RTOL, ATOL = 1e-4, 1e-5
DEEP_RTOL = 1e-5
MARGIN = 1e-3
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
ADAM_ATOL = 1e-6
LAYERS = (1, 1, 1, 1)
H, W = 64, 48
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, ref, what, deep=False):
    """Elementwise within ATOL + RTOL |ref|; `deep` (a stack of many fp32
    convs, whose reordered sums stray in absolute terms) within DEEP_RTOL
    of max |ref|."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref)
    if deep:
        bad = err > DEEP_RTOL * np.abs(ref).max()
    else:
        bad = err > ATOL + RTOL * np.abs(ref)
    assert not bad.any(), (what, float(err.max()), float(np.abs(ref).max()))


def _carried(module, seed=0):
    """(JAX variables, port state_dict) of the same perturbed weights,
    from the port's seeded init of `module`."""
    random_init_(module, torch.Generator().manual_seed(seed))
    # cloned: `to_jax_variables` may hand out views of the parameters
    state = {k: t.clone() for k, t in module.state_dict().items()}
    v = perturb(to_jax_variables(state), seed + 1)
    return v, from_jax_variables(v)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# --- the backbones ---------------------------------------------------


@pytest.mark.parametrize("layers", [(1, 1, 1, 1), (2, 1, 3, 1)])
def test_resnet_all_taps(layers):
    """Every bottleneck's pre-relu sum in block order, as JAX's
    `all_taps`; the default path still returns the stage outputs, the
    relu of each stage's last tap."""
    taps_model = ResNetBackbone(ResNetConfig(layers=layers),
                                all_taps=True).eval()
    v, sd = _carried(taps_model)
    taps_model.load_state_dict(sd)
    stages_model = ResNetBackbone(ResNetConfig(layers=layers)).eval()
    stages_model.load_state_dict(sd)
    x = np.random.RandomState(0).randn(2, H, W, 3).astype(np.float32)
    with torch.no_grad():
        taps = taps_model(_t(x))
        stages = stages_model(_t(x))
    ref = jax.jit(JResNet(JResNetConfig(layers=layers), all_taps=True).apply)(
        v, jnp.asarray(x))
    assert len(taps) == len(ref) == sum(layers)
    for i, (got, want) in enumerate(zip(taps, ref)):
        _close(got.numpy(), want, f"tap {i}")
    assert (min(float(t.min()) for t in taps) < 0)  # taken before the relu
    ends = np.cumsum(layers) - 1
    for s, e in enumerate(ends):
        assert torch.equal(stages[s], torch.relu(taps[e]))


def _torchvision_vgg16_sd(seed=0):
    from lseg_tpu.models.vgg import _VGG16_LAYOUT

    rng = np.random.RandomState(seed)
    sd, idx, cin = {}, 0, 3
    for item in _VGG16_LAYOUT:
        if item == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = (
            rng.randn(item, cin, 3, 3).astype(np.float32) * 0.05)
        sd[f"features.{idx}.bias"] = rng.randn(item).astype(np.float32) * 0.05
        cin = item
        idx += 2
    return sd


def test_vgg16_features_and_key_map():
    """The key map gives the weights `convert_torchvision_vgg16` gives
    (bit for bit after `from_jax_variables`), and the seven taps (strides
    8, 8, 8, 16, 16, 16, 32) match JAX's."""
    sd = _torchvision_vgg16_sd()
    got = apply_key_map(sd, torchvision_vgg16_key_map())
    want = from_jax_variables({"params": convert_torchvision_vgg16(sd)})
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    model = VGG16Features()
    model.load_state_dict(got)
    x = np.random.RandomState(1).randn(1, H, H, 3).astype(np.float32)
    with torch.no_grad():
        taps = model(_t(x))
    ref = JVGG().apply({"params": convert_torchvision_vgg16(sd)},
                       jnp.asarray(x))
    assert len(taps) == len(HSNET_VGG_TAPS) == len(ref)
    assert [t.shape[1] for t in taps] == [8, 8, 8, 4, 4, 4, 2]
    for i, (t, r) in enumerate(zip(taps, ref)):
        _close(t.numpy(), r, f"vgg tap {HSNET_VGG_TAPS[i]}", deep=True)


@pytest.mark.parametrize("backbone", ["resnet", "vgg16"])
def test_torchvision_resnet_key_map_under_backbone(tmp_path, backbone):
    """`hsnet.load_backbone` reads a torchvision `state_dict` file into
    HSNet's backbone (ResNet through `torchvision_resnet_key_map`, VGG16
    through `torchvision_vgg16_key_map`, under the `backbone.` prefix):
    every backbone entry, bit for bit; the learner keeps its weights."""
    net = hsnet.HSNet(ResNetConfig(layers=LAYERS), backbone)
    random_init_(net, torch.Generator().manual_seed(4))
    learner = {k: t.clone() for k, t in net.hpn_learner.state_dict().items()}
    if backbone == "resnet":
        ref = ResNetBackbone(ResNetConfig(layers=LAYERS))
        random_init_(ref, torch.Generator().manual_seed(3))
        sd, want = {}, ref.state_dict()
        for name, t in want.items():
            name = name.replace("_block", ".").replace(".down_conv",
                                                       ".downsample.0")
            sd[name.replace(".down_bn", ".downsample.1")] = t
    else:
        sd = {k: torch.from_numpy(a) for k, a in
              _torchvision_vgg16_sd().items()}
        want = {f"conv{k[len('features.'):]}": t for k, t in sd.items()}
    path = str(tmp_path / "backbone.pth")
    torch.save(sd, path)
    key_map = hsnet.load_backbone(net, path)
    state = net.state_dict()
    assert len(key_map) == len(want) == len(net.backbone.state_dict())
    for name, t in want.items():
        assert torch.equal(state[f"backbone.{name}"], t), name
    for k, t in net.hpn_learner.state_dict().items():
        assert torch.equal(t, learner[k]), k


# --- the learner's modules -------------------------------------------


def test_multilayer_correlation_grouping():
    """(#layer4, #layer3, #layer2) = (2, 3, 2) taps: the three groups'
    shapes and values."""
    rng = np.random.RandomState(0)
    fq, fs = [], []
    for n, (h, w), c in [(2, (8, 6), 4), (3, (4, 3), 8), (2, (2, 2), 8)]:
        for _ in range(n):
            fq.append(rng.randn(2, h, w, c).astype(np.float32))
            fs.append(rng.randn(2, h, w, c).astype(np.float32))
    got = hsnet.multilayer_correlation([_t(a) for a in fq],
                                       [_t(a) for a in fs], (2, 3, 2))
    ref = jhsnet.multilayer_correlation([jnp.asarray(a) for a in fq],
                                        [jnp.asarray(a) for a in fs],
                                        (2, 3, 2))
    assert [tuple(p.shape) for p in got] == [
        (2, 2, 2, 2, 2, 2), (2, 4, 3, 4, 3, 3), (2, 8, 6, 8, 6, 2)]
    for g, r in zip(got, ref):
        _close(g.numpy(), r, "pyramid")
        assert float(g.min()) >= 0.0


@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (5, 2), (5, 4),
                                           (3, 4), (5, 1)])
def test_center_pivot_conv4d(kernel, stride):
    x = np.random.RandomState(kernel * stride).randn(
        2, 5, 6, 9, 7, 3).astype(np.float32)
    mod = hsnet.CenterPivotConv4d(3, 4, kernel, stride)
    v, sd = _carried(mod)
    mod.load_state_dict(sd)
    with torch.no_grad():
        got = mod(_t(x))
    ref = jhsnet.CenterPivotConv4d(4, kernel, stride).apply(
        v, jnp.asarray(x))
    _close(got.numpy(), ref, "cp4d")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_6d(dtype):
    """flax `nn.GroupNorm(num_groups=4)` (epsilon 1e-6) on a 6-D
    channels-last tensor, its statistics in fp32 under bf16."""
    import flax.linen as fnn

    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 5, 4, 3, 3, 16) * 3 + 1).astype(np.float32)
    # a group of variance ~1e-6, where the epsilon matters (centred, so
    # E[x^2] - E[x]^2 does not cancel)
    x[1, ..., :4] = 1e-3 * rng.randn(5, 4, 3, 3, 4)
    gn = GroupNorm(4, 16, dtype=tdt)
    v, sd = _carried(gn)
    gn.load_state_dict(sd)
    with torch.no_grad():
        got = gn(_t(x).to(tdt)).float().numpy()
    ref = fnn.GroupNorm(num_groups=4, dtype=jdt).apply(
        v, jnp.asarray(x, jdt))
    if dtype == "float32":
        _close(got, ref, "group norm")
    else:
        xb = _t(x).to(tdt).float().numpy()
        ref32 = fnn.GroupNorm(num_groups=4).apply(v, jnp.asarray(xb))
        assert_bf16_bound(got, _f32(ref), _f32(ref32), "group norm bf16")
        # fp32 statistics of the bf16 input leave one bf16 rounding of the
        # output: within 2^-8 of |fp32 output| (statistics taken in bf16
        # fail this)
        ref32 = _f32(ref32)
        assert np.all(np.abs(got - ref32)
                      <= 2.0 ** -8 * np.abs(ref32) + 1e-5)


def test_building_block_and_hpn_learner():
    rng = np.random.RandomState(0)
    x = np.abs(rng.randn(2, 6, 5, 9, 7, 3)).astype(np.float32)
    block = hsnet.BuildingBlock(3, (8, 8, 16), (5, 3, 3), (4, 2, 2))
    v, sd = _carried(block)
    block.load_state_dict(sd)
    with torch.no_grad():
        got = block(_t(x))
    ref = jax.jit(jhsnet.BuildingBlock((8, 8, 16), (5, 3, 3),
                                       (4, 2, 2)).apply)(v, jnp.asarray(x))
    _close(got.numpy(), ref, "building block")

    pyr = [np.abs(rng.randn(2, 2, 2, 2, 2, 1)).astype(np.float32),
           np.abs(rng.randn(2, 4, 3, 4, 3, 2)).astype(np.float32),
           np.abs(rng.randn(2, 8, 6, 8, 6, 3)).astype(np.float32)]
    learner = hsnet.HPNLearner((1, 2, 3))
    v, sd = _carried(learner, seed=5)
    learner.load_state_dict(sd)
    with torch.no_grad():
        got = learner([_t(p) for p in pyr])
    ref = jax.jit(jhsnet.HPNLearner((1, 2, 3)).apply)(
        v, [jnp.asarray(p) for p in pyr])
    # the square upsample keyed on W: 8 x 6 query rows -> 12 x 12
    assert got.shape == (2, 12, 12, 2)
    _close(got.numpy(), ref, "hpn learner")


# --- the whole model -------------------------------------------------


def _episode(seed=0, n=2, shots=3):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, H, W, 3).astype(np.float32)
    s = rng.randn(n, shots, H, W, 3).astype(np.float32)
    m = np.zeros((n, shots, H, W), np.int32)
    for i in range(n):
        for j in range(shots):
            y, x = rng.randint(0, H // 2), rng.randint(0, W // 2)
            m[i, j, y:y + H // 2, x:x + W // 2] = 1
    return {"query_img": q, "support_imgs": s, "support_masks": m}


@pytest.fixture(scope="module")
def models():
    """Per (backbone, dtype): the port's HSNet at the learner's resolution
    and at the input's, the carried JAX variables, and JAX's jitted
    `use_original_imgsize` apply (the default model's output is its
    align-corners resize to the input size, the same ops)."""
    out = {}
    for backbone in ("resnet", "vgg16"):
        base = hsnet.HSNet(ResNetConfig(layers=LAYERS), backbone)
        v, sd = _carried(base, seed=7)
        for dtype, (tdt, jdt) in DTYPES.items():
            nets = {}
            for orig in (True, False):
                net = hsnet.HSNet(ResNetConfig(layers=LAYERS), backbone,
                                  tdt, use_original_imgsize=orig)
                net.load_state_dict(sd)
                nets[orig] = net
            jm = jhsnet.HSNet(resnet=JResNetConfig(layers=LAYERS),
                              backbone=backbone, dtype=jdt,
                              use_original_imgsize=True)
            out[backbone, dtype] = (nets, v, jax.jit(
                lambda q, s, m, jm=jm, v=v: jm.apply(v, q, s, m)))
    return out


def _jax_logits(apply, q, s, m, orig):
    out = apply(jnp.asarray(q), jnp.asarray(s), jnp.asarray(m))
    return out if orig else j_resize(out, H, W, align_corners=True)


@pytest.mark.parametrize("orig", [False, True],
                         ids=["input_size", "original_imgsize"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backbone", ["resnet", "vgg16"])
def test_hsnet_forward(models, backbone, dtype, orig):
    nets, _, apply = models[backbone, dtype]
    ep = _episode()
    args = (ep["query_img"], ep["support_imgs"][:, 0],
            ep["support_masks"][:, 0])
    with torch.no_grad():
        got = nets[orig](*(_t(a) for a in args))
    assert got.dtype == DTYPES[dtype][0]
    # 64 x 48 input: layer2 at 8 x 6, the decoder's square x2 -> 12 x 12
    assert got.shape == ((2, 12, 12, 2) if orig else (2, H, W, 2))
    ref = _jax_logits(apply, *args, orig)
    if dtype == "float32":
        _close(got.numpy(), ref, f"{backbone} logits")
    else:
        ref32 = _jax_logits(models[backbone, "float32"][2], *args, orig)
        assert_bf16_bound(got.float().numpy(), _f32(ref), _f32(ref32),
                          f"{backbone} bf16 logits")


@pytest.mark.parametrize("org_size", [None, (47, 31)],
                         ids=["input_size", "org_size"])
@pytest.mark.parametrize("nshot", [1, 3])
def test_predict_mask_nshot(models, nshot, org_size):
    nets, _, apply = models["resnet", "float32"]
    orig = org_size is not None
    ep = _episode(seed=2)

    def j_apply(q, s, m):
        return _jax_logits(apply, q, s, m, orig)

    want = np.asarray(jhsnet.predict_mask_nshot(
        j_apply, {k: jnp.asarray(a) for k, a in ep.items()}, nshot,
        org_size=org_size))
    with torch.no_grad():
        got = hsnet.predict_mask_nshot(
            nets[orig], {k: _t(a) for k, a in ep.items()}, nshot,
            org_size=org_size).numpy()
    assert got.shape == want.shape == ((2,) + (org_size or (H, W)))
    # every shot's JAX margin
    clear = np.ones(got.shape, bool)
    for s in range(nshot):
        lg = _f32(j_apply(ep["query_img"], ep["support_imgs"][:, s],
                          ep["support_masks"][:, s]))
        if orig:
            lg = _f32(j_resize(jnp.asarray(lg), *org_size,
                               align_corners=True))
        clear &= np.abs(lg[..., 1] - lg[..., 0]) > MARGIN
    assert clear.mean() > 0.9
    assert np.array_equal(got[clear], want[clear])
    assert set(np.unique(got)) <= {0, 1}


# --- training --------------------------------------------------------


def test_train_step_against_jax_grad_and_optax():
    """One fp32 step: the learner's gradients against `jax.grad` of the
    same loss, the backbone without a gradient, its weights and BatchNorm
    statistics unchanged and in eval mode; then Adam against optax.adam
    on the same gradients over two steps."""
    net = hsnet.HSNet(ResNetConfig(layers=LAYERS))
    v, sd = _carried(net, seed=11)
    net.load_state_dict(sd)
    ep = _episode(seed=3, shots=1)
    qmask = (np.random.RandomState(4).rand(2, H, W) < 0.3).astype(np.int32)
    backbone_before = {k: t.clone() for k, t in
                       net.backbone.state_dict().items()}
    opt = hsnet_run.make_optimizer(net, 1e-3)
    batch = {"query_img": _t(ep["query_img"]),
             "support_imgs": _t(ep["support_imgs"]),
             "support_masks": _t(ep["support_masks"]),
             "query_mask": _t(qmask)}
    loss = hsnet_run.train_step(net, opt, batch)
    # Adam leaves the step's gradients in place
    grads = {n: p.grad.clone() for n, p in
             net.hpn_learner.named_parameters()}

    jm = jhsnet.HSNet(resnet=JResNetConfig(layers=LAYERS))

    def loss_fn(params):
        logits = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]},
                          jnp.asarray(ep["query_img"]),
                          jnp.asarray(ep["support_imgs"][:, 0]),
                          jnp.asarray(ep["support_masks"][:, 0]))
        return j_cross_entropy(logits, jnp.asarray(qmask))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    assert abs(float(loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    j_grads = jax.tree_util.tree_map(np.asarray, j_grads)
    assert not any(np.any(a) for a in
                   jax.tree_util.tree_leaves(j_grads["backbone"]))
    want = from_jax_variables({"params": {"hpn_learner":
                                          j_grads["hpn_learner"]}})
    assert {f"hpn_learner.{k}" for k in grads} == set(want)
    for name, g in grads.items():
        w = want[f"hpn_learner.{name}"]
        err = float((g - w).abs().max())
        assert err <= GRAD_RTOL * float(w.abs().max()) + GRAD_ATOL, name
    assert all(not p.requires_grad and p.grad is None
               for p in net.backbone.parameters())
    assert not net.backbone.training and net.hpn_learner.training
    for k, t in net.backbone.state_dict().items():
        assert torch.equal(t, backbone_before[k]), k

    # Adam against optax.adam on the same gradients, two steps
    params = {n: p.detach().clone().requires_grad_(True)
              for n, p in net.hpn_learner.named_parameters()}
    t_opt = torch.optim.Adam(params.values(), lr=1e-3, betas=(0.9, 0.999),
                             eps=1e-8)
    tx = optax.adam(1e-3)
    j_params = {n: p.detach().numpy().copy() for n, p in params.items()}
    state = tx.init(j_params)
    rng = np.random.RandomState(5)
    for step in range(2):
        g = {n: grads[n] * (1.0 if step == 0 else 0.5)
             + 1e-4 * torch.from_numpy(rng.randn(*grads[n].shape).astype(
                 np.float32)) for n in params}
        for n, p in params.items():
            p.grad = g[n].clone()
        t_opt.step()
        upd, state = tx.update({n: g[n].numpy() for n in g}, state,
                               j_params)
        j_params = optax.apply_updates(j_params, upd)
    for n, p in params.items():
        err = float(np.abs(p.detach().numpy() - np.asarray(j_params[n])).max())
        assert err <= ADAM_ATOL, (n, err)


# --- the CLI ---------------------------------------------------------


def _write_tree(root, h=40, w=50):
    """A PASCAL-5i tree: two images a class for fold 0's classes 0-4
    (`val/fold0.txt`) and for classes 5, 10 and 15 (`trn/fold1..3.txt`),
    masks holding the class (1-based) in a box, a 255 rim on top."""
    from PIL import Image

    rng = np.random.RandomState(0)
    img_dir = root / "VOC2012" / "JPEGImages"
    ann_dir = root / "VOC2012" / "SegmentationClassAug"
    for d in (img_dir, ann_dir):
        d.mkdir(parents=True)
    splits = {("val", 0): range(5), ("trn", 1): [5], ("trn", 2): [10],
              ("trn", 3): [15]}
    for (split, fold), classes in splits.items():
        lines = []
        for c in classes:
            for j in range(2):
                name = f"2008_{c:03d}{j:03d}"
                Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)
                                ).save(img_dir / f"{name}.jpg")
                mask = np.zeros((h, w), np.uint8)
                y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
                mask[y:y + h // 2, x:x + w // 2] = c + 1
                mask[:2] = 255
                Image.fromarray(mask).save(ann_dir / f"{name}.png")
                lines.append(f"{name}__{c + 1}")
        d = root / "splits" / "pascal" / split
        d.mkdir(parents=True, exist_ok=True)
        (d / f"fold{fold}.txt").write_text("\n".join(lines) + "\n")
    return str(root), str(root / "splits")


def test_hsnet_run_batches_in_order(tmp_path):
    """`hsnet_run.batches` (the next batch decoded by threads) yields the
    batches that stacking the episodes one by one gives, in order."""
    datapath, splits = _write_tree(tmp_path / "data")
    args = hsnet_run.parse_args(["test", "--datapath", datapath,
                                 "--splits_dir", splits, "--nshot", "2",
                                 "--img_size", "32", "--device", "cpu"])
    ds = hsnet_run.episodes(args, "test")
    lists = [[5, 0, 3], [999], [7, 7]]
    got = list(hsnet_run.batches(ds, iter(lists), torch.device("cpu")))
    assert len(got) == len(lists)
    for (batch, cids), idxs in zip(got, lists):
        eps = [ds[i] for i in idxs]
        assert list(cids) == [e["class_id"] for e in eps]
        for k, t in batch.items():
            assert np.array_equal(t.numpy(), np.stack([e[k] for e in eps])), k


def test_hsnet_run_cli_on_the_cpu(tmp_path, capsys):
    """`test` over the 1000-episode protocol (its progress and FINAL
    lines); `--use_original_imgsize` (bsz forced to 1) with a backbone
    from a torchvision `.pth` and two shots at the original size;
    `--visualize` (a composite an episode); `train --niter 3`; `--device
    cuda` without a card exits naming `--device cpu`."""
    datapath, splits = _write_tree(tmp_path / "data")
    common = ["--datapath", datapath, "--splits_dir", splits,
              "--layers", "1", "1", "1", "1", "--img_size", "32",
              "--device", "cpu"]
    miou, fb = hsnet_run.main(["test", "--bsz", "250"] + common)
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("[250/1000] mIoU ")
    assert out[-1] == (f"FINAL pascal fold0 1-shot mIoU {miou:.2f} "
                       f"FB-IoU {fb:.2f}")
    assert 0.0 <= miou <= 100.0 and 0.0 < fb <= 100.0

    # a torchvision-format backbone file, read through the key map
    ref = ResNetBackbone(ResNetConfig(layers=LAYERS))
    random_init_(ref, torch.Generator().manual_seed(9))
    sd = {}
    for name, t in ref.state_dict().items():
        name = name.replace("_block", ".").replace(".down_conv",
                                                   ".downsample.0")
        sd[name.replace(".down_bn", ".downsample.1")] = t
    pth = str(tmp_path / "resnet.pth")
    torch.save(sd, pth)
    args = hsnet_run.parse_args(["test", "--use_original_imgsize",
                                 "--nshot", "2", "--backbone_weights",
                                 pth] + common)
    assert args.bsz == 1
    model = hsnet_run.build(args)
    for name, t in ref.state_dict().items():
        got = model.state_dict()[f"backbone.{name}"]
        assert torch.equal(got, t.to(got.dtype)), name
    ds = hsnet_run.episodes(args, "test")
    assert ds[0]["query_mask"].shape == (40, 50)
    batch, _ = next(hsnet_run.batches(ds, [[0]], torch.device("cpu")))
    with torch.no_grad():
        pred = hsnet.predict_mask_nshot(model, batch, 2, org_size=(40, 50))
    assert pred.shape == (1, 40, 50)

    args = hsnet_run.parse_args(["test", "--visualize", "--vis_path",
                                 str(tmp_path / "vis"), "--bsz", "2"]
                                + common)
    ds = hsnet_run.episodes(args, "test")

    class FirstFour:
        class_ids = ds.class_ids

        def __len__(self):
            return 4

        def __getitem__(self, i):
            return ds[i]

    hsnet_run.test(args, hsnet_run.build(args), FirstFour())
    assert len(list((tmp_path / "vis").iterdir())) == 4
    capsys.readouterr()

    hsnet_run.main(["train", "--niter", "3", "--bsz", "2"] + common)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("iter 0 loss ")
    assert np.isfinite(float(lines[0].split()[-1]))

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            hsnet_run.main(["test"] + common[:-2])
