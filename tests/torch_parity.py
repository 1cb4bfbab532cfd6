"""Shared set-up of the `test_torch_*` parity tests: one tiny config with
head_dim 64 (so the fast config takes the flat flash kernel), seeded
inputs, and JAX variables with every parameter and batch statistic
perturbed away from its initial value, so a conversion that dropped or
transposed one would show."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lseg_tpu.config import ViTConfig, fast_serving, flat_flash_eligible
from lseg_tpu.testing import tiny_vit_config

# bf16 bound: the port's bf16 output may stray from the JAX bf16 output
# by at most twice what the JAX bf16 output strays from the fp32 one,
# plus a floor of a few bf16 ulps at the logit scale for outputs whose
# d_ref happens to be tiny.
BF16_RATIO = 2.0
BF16_FLOOR = 0.05


def tiny_parity_config():
    cfg = tiny_vit_config(vit=ViTConfig(
        embed_dim=128, num_heads=2, depth=4, hooks=(0, 1, 2, 3),
        post_channels=(16, 32, 64, 64), pretrain_grid=4))
    assert flat_flash_eligible(cfg.vit.embed_dim, cfg.vit.num_heads,
                               cfg.vit.tp_layout)
    return cfg


def tiny_vitb_config(patch: int):
    """A ViT-B-shaped parity config at width 128 (two heads of 64): 12
    blocks tapped at (2, 5, 8, 11); patch 32 takes ViT-B/32's resample
    (8, 4, 2, 1), patch 16 ViT-B/16's (4, 2, 1, 0.5). The pretraining
    grid (3 or 4) differs from the 64 x 96 input's grid, so the position
    embedding is resized."""
    resample = (8.0, 4.0, 2.0, 1.0) if patch == 32 else (4.0, 2.0, 1.0, 0.5)
    cfg = tiny_vit_config(vit=ViTConfig(
        patch_size=patch, embed_dim=128, num_heads=2, depth=12,
        hooks=(2, 5, 8, 11), post_channels=(16, 32, 64, 64),
        resample=resample, pretrain_grid=3 if patch == 32 else 4))
    assert flat_flash_eligible(cfg.vit.embed_dim, cfg.vit.num_heads,
                               cfg.vit.tp_layout)
    return cfg


def tiny_text_config(width: int):
    """The CLIP text tower at the RN50x4 (640, ten heads) or RN50x16 (768,
    twelve heads) widths, two layers, the tiny vocabulary and context."""
    from lseg_tpu.config import CLIPTextConfig

    return CLIPTextConfig(vocab_size=1024, context_length=16, width=width,
                          layers=2, heads=width // 64, embed_dim=width)


def seeded_variables(cfg, seed=0):
    """JAX variables of `cfg` without running JAX's init (op by op, 20-30
    s at these sizes): the port's seeded `random_init_` carried into the
    JAX tree by `to_jax_variables`, then perturbed as
    `jax_lseg_variables`' are."""
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.utils.convert import to_jax_variables

    model = random_init_(LSegNet(cfg), torch.Generator().manual_seed(seed))
    hooks = cfg.vit.hooks if cfg.vit is not None else ()
    return perturb(to_jax_variables(model.state_dict(), hooks), seed + 1)


def tiny_fast_config():
    """`fast_serving(quant=False)`: flashflat, patch kernel, tanh GELU,
    bf16 head."""
    cfg = fast_serving(tiny_parity_config(), quant=False)
    assert cfg.vit.attn_impl == "flashflat" and cfg.vit.patch_fused
    return cfg


def fp32_reference_of(cfg):
    """The same function as a fast config, computed in fp32 throughout."""
    return dataclasses.replace(cfg, head_dtype="float32")


def inputs(seed=0, n=2, h=64, w=96, k=5, out_c=64):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, 3).astype(np.float32)
    txt = rng.randn(k, out_c).astype(np.float32)
    return x, txt


def perturb(tree, seed=1):
    """numpy copy of a variables tree with every leaf moved off its
    init: biases/means get noise, scales/variances 1 + |noise|."""
    rng = np.random.RandomState(seed)

    def visit(path, a):
        a = np.asarray(a, dtype=np.float32)
        name = path[-1].key
        noise = rng.randn(*a.shape).astype(np.float32)
        if name in ("bias", "mean", "cls_token"):
            return a + 0.1 * noise
        if name in ("scale", "var"):
            return 1.0 + 0.1 * np.abs(noise)
        return a

    out = jax.tree_util.tree_map_with_path(visit, tree)
    return jax.tree_util.tree_map(np.asarray, out)


def jax_lseg_variables(cfg, x, txt, seed=0):
    from lseg_tpu.models.lseg import LSegNet

    v = LSegNet(cfg).init(jax.random.PRNGKey(seed), jnp.asarray(x),
                          jnp.asarray(txt))
    return perturb(v, seed + 1)


def f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_bf16_bound(got, jax_bf16, jax_fp32, what):
    d_port = float(np.max(np.abs(got - jax_bf16)))
    d_ref = float(np.max(np.abs(jax_bf16 - jax_fp32)))
    assert d_port <= BF16_RATIO * d_ref + BF16_FLOOR, (
        f"{what}: d_port={d_port} > {BF16_RATIO} * d_ref={d_ref} "
        f"+ {BF16_FLOOR}")
    return d_port, d_ref


@pytest.fixture
def cuda_device():
    """The card, or a skip: tests that run a CUDA kernel need one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# --- few-shot fixtures ------------------------------------------------


@pytest.fixture(scope="module")
def native_libs(tmp_path_factory):
    """Both packages' `data.native` on one private build of
    `native/lseg_io.cpp`, made before any comparison: with xdist, another
    worker may be writing the shared `native/liblseg_io.so` at the moment
    a module loads it, and a reader of a half-written library takes the
    PIL route, so the two packages' arrays would differ. Yields whether
    the library is available, the same in both packages; the modules'
    own paths and state come back afterwards."""
    from lseg_tpu.data import native as jnative
    from lseg_tpu_torch.data import native as tnative

    so = str(tmp_path_factory.mktemp("native") / "liblseg_io.so")
    mods = (tnative, jnative)
    saved = [(m._SO, m._lib, m._tried) for m in mods]
    for m in mods:
        m._SO, m._lib, m._tried = so, None, False
    try:
        ok = [m.available() for m in mods]
        assert ok[0] == ok[1], ok
        yield ok[0]
    finally:
        for m, (path, lib, tried) in zip(mods, saved):
            m._SO, m._lib, m._tried = path, lib, tried


def _save_image(path, rng, h, w):
    Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(path)


def write_voc_tree(root, names_per_class, h=50, w=60, seed=0):
    """A PASCAL-5i tree under `root`: `VOC2012/JPEGImages/<name>.jpg`,
    `VOC2012/SegmentationClassAug/<name>.png` (the class, 1-based, in a
    box, and a 255 ignore rim) and `splits/pascal/val/fold0.txt` of
    'name__class' lines. Returns (datapath, splits_dir)."""
    root = Path(root)
    img_dir = root / "VOC2012" / "JPEGImages"
    ann_dir = root / "VOC2012" / "SegmentationClassAug"
    splits = root / "splits" / "pascal" / "val"
    for d in (img_dir, ann_dir, splits):
        d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    lines = []
    for cid, names in names_per_class.items():
        for name in names:
            _save_image(img_dir / f"{name}.jpg", rng, h, w)
            mask = np.zeros((h, w), np.uint8)
            y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
            mask[y:y + h // 2, x:x + w // 2] = cid + 1
            mask[:3] = 255
            Image.fromarray(mask).save(ann_dir / f"{name}.png")
            lines.append(f"{name}__{cid + 1}")
    (splits / "fold0.txt").write_text("\n".join(lines) + "\n")
    return str(root), str(root / "splits")


def write_coco_tree(root, class_ids, per_class=2, h=40, w=50, seed=1):
    """A COCO-20i tree: `COCO2014/val2014/*.jpg`, masks under
    `COCO2014/annotations/val2014/*.png`, and the classwise dict in
    `splits/coco/val/fold0.pkl`."""
    import pickle

    root = Path(root)
    base = root / "COCO2014"
    (base / "val2014").mkdir(parents=True, exist_ok=True)
    (base / "annotations" / "val2014").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    classwise = {}
    for cid in class_ids:
        names = []
        for j in range(per_class):
            name = f"val2014/COCO_val2014_c{cid}_{j}.jpg"
            _save_image(base / name, rng, h, w)
            m = np.zeros((h, w), np.uint8)
            m[5:20, 5:30] = cid + 1
            Image.fromarray(m).save(base / "annotations"
                                    / (name[:-4] + ".png"))
            names.append(name)
        classwise[cid] = names
    splits = root / "splits" / "coco" / "val"
    splits.mkdir(parents=True, exist_ok=True)
    with open(splits / "fold0.pkl", "wb") as f:
        pickle.dump(classwise, f)
    return str(root), str(root / "splits")


def write_fss_tree(root, cats, n=10, size=40, seed=2):
    """An FSS-1000 tree: `FSS-1000/<cat>/<i>.jpg` and `<i>.png` masks for
    i = 1..n (the reader draws supports from 1..10), and
    `splits/fss/test.txt`."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    for cat in cats:
        d = root / "FSS-1000" / cat
        d.mkdir(parents=True, exist_ok=True)
        for i in range(1, n + 1):
            _save_image(d / f"{i}.jpg", rng, size, size)
            m = np.zeros((size, size), np.uint8)
            m[5:20, 5 + i:20 + i] = 255
            Image.fromarray(m).save(d / f"{i}.png")
    splits = root / "splits" / "fss"
    splits.mkdir(parents=True, exist_ok=True)
    (splits / "test.txt").write_text("\n".join(cats) + "\n")
    return str(root), str(root / "splits")
