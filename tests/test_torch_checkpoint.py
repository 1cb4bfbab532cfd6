"""The port's reference-checkpoint loader, text tower loading and `.npz`
export / import against the JAX package's, on files written by the JAX
package's `write_reference_ckpt` / `write_reference_vocab` at the tiny
config's widths; and the training CLI's `--ckpt` / `--bpe_vocab`."""

import dataclasses
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    jax_lseg_variables,
    seeded_variables,
    tiny_parity_config,
    tiny_text_config,
    tiny_vitb_config,
)

from lseg_tpu.models.lseg import LSegNet as JNet
from lseg_tpu.ops.quant import quantize_tree as j_quantize_tree
from lseg_tpu.testing import (
    TINY_TEXT,
    tiny_rn_config,
    tiny_vit_config,
    write_reference_ckpt,
    write_reference_vocab,
)
from lseg_tpu.text.cache import TextFeatureCache as JCache
from lseg_tpu.text.tokenizer import ClipBPETokenizer as JTokenizer
from lseg_tpu.train import checkpoint as jckpt
from lseg_tpu.utils.checkpoint_convert import (
    load_reference_checkpoint as j_load,
)
from lseg_tpu_torch import fast_serving
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.text.cache import TextFeatureCache
from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer
from lseg_tpu_torch.train import checkpoint as tckpt
from lseg_tpu_torch.utils.checkpoint_convert import (
    apply_key_map,
    clip_visual_key_map,
    extract_state_dict,
    load_reference_checkpoint,
    load_torch_file,
    torchvision_resnet_key_map,
)
from lseg_tpu_torch.utils.convert import (
    from_jax_text_params,
    from_jax_variables,
)

REPO = Path(__file__).resolve().parent.parent
LABELS = ["the cat", "dog", "other", "grass and stone", "plant"]
# the fp32 logits tolerance of tests/test_torch_lseg.py
FP32_LOGITS_ATOL = 1e-3


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    ckpt, vocab = str(d / "ref.ckpt"), str(d / "bpe.txt.gz")
    write_reference_ckpt(ckpt, tiny_vit_config())
    write_reference_vocab(vocab)
    return ckpt, vocab


@pytest.fixture(scope="module")
def loaded(files):
    ckpt, _ = files
    return j_load(ckpt, tiny_vit_config()), load_reference_checkpoint(
        ckpt, tiny_vit_config())


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k


def test_loader_equals_the_jax_path_bit_for_bit(loaded):
    (jvars, jtext), (state, text) = loaded
    _assert_same(state, from_jax_variables(jvars))
    _assert_same(text, from_jax_text_params(jtext["params"]))
    LSegNet(tiny_vit_config()).load_state_dict(state, strict=True)


def test_loaded_logits_match_jax(loaded):
    (jvars, _), (state, _) = loaded
    cfg = tiny_vit_config()
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 96, 3).astype(np.float32)
    txt = rng.randn(5, cfg.out_c).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, a, b: JNet(cfg).apply(v, a, b))(
        jvars, jnp.asarray(x), jnp.asarray(txt)))
    model = LSegNet(cfg)
    model.load_state_dict(state)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(txt))
    assert got.shape == ref.shape
    assert float(np.max(np.abs(got.numpy() - ref))) <= FP32_LOGITS_ATOL


def test_text_features_from_the_checkpoint_match_jax(files, loaded):
    _, vocab = files
    (_, jtext), (_, text) = loaded
    tc = tiny_vit_config().text
    ref = np.asarray(JCache(tc, jtext, JTokenizer.from_file(
        vocab, tc.context_length))(LABELS))
    got = TextFeatureCache(tc, text, ClipBPETokenizer.from_file(
        vocab, tc.context_length), device="cpu")(LABELS)
    # the fp32 tolerance of tests/test_torch_text.py
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_ckpt_with_unimportable_hyper_parameters_loads(tmp_path):
    """A Lightning checkpoint whose `hyper_parameters` pickle an object of
    a class that cannot be imported at load time (lang-seg's own modules)
    loads: the unpickler stubs it, where `torch.load` raises."""
    mod = types.ModuleType("langseg_options_gone")

    class Options:
        def __init__(self):
            self.backbone = "clip_vitl16_384"

    Options.__module__ = mod.__name__
    Options.__qualname__ = "Options"
    mod.Options = Options
    sys.modules[mod.__name__] = mod
    path = str(tmp_path / "hp.ckpt")
    w = torch.randn(4, 3)
    try:
        torch.save({"state_dict": {"net.head1.weight": w},
                    "hyper_parameters": {"opts": Options()}}, path)
    finally:
        del sys.modules[mod.__name__]
    with pytest.raises((pickle.UnpicklingError, ModuleNotFoundError,
                        AttributeError)):
        torch.load(path, weights_only=False)
    sd = extract_state_dict(load_torch_file(path))
    assert set(sd) == {"head1.weight"}
    np.testing.assert_array_equal(sd["head1.weight"], w.numpy())


def _jax_int8_tree(cfg):
    rng = np.random.RandomState(0)
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    txt = rng.randn(5, cfg.out_c).astype(np.float32)
    v = jax_lseg_variables(cfg, x, txt)
    return {"params": j_quantize_tree(v["params"], decoder=True,
                                      act_scale=True),
            "batch_stats": v["batch_stats"]}


def _trees(kind, loaded):
    """(JAX variables, the port config that holds them)."""
    if kind == "float":
        (jvars, _), _ = loaded
        return jvars, tiny_vit_config()
    if kind == "resnet":
        return seeded_variables(tiny_rn_config()), tiny_rn_config()
    cfg = tiny_parity_config()
    return _jax_int8_tree(cfg), fast_serving(cfg, "static_cal")


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(a)
            for k, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("kind", ["float", "int8", "resnet"])
def test_jax_npz_export_imports_into_the_port(kind, loaded, tmp_path):
    jvars, _ = _trees(kind, loaded)

    class State:
        params = jvars["params"]
        batch_stats = jvars["batch_stats"]

    path = str(tmp_path / "jax.npz")
    jckpt.export_params(path, State())
    _assert_same(tckpt.import_params(path), from_jax_variables(jvars))


@pytest.mark.parametrize("kind", ["float", "int8", "resnet"])
def test_port_npz_export_imports_into_jax(kind, loaded, tmp_path):
    jvars, cfg = _trees(kind, loaded)
    model = LSegNet(cfg)
    model.load_state_dict(from_jax_variables(jvars), strict=True)
    path = str(tmp_path / "port.npz")
    tckpt.export_params(path, model)
    got, want = _leaves(jckpt.import_params(path)), _leaves(jvars)
    assert set(got) == set(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and np.array_equal(got[k], a), k


def _train(tmp_path, *flags):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "lseg_tpu_torch.train", "--dataset",
         "synthetic", "--dry-run", "--crop_size", "64", "--batch_size", "2",
         "--num_workers", "1", "--dtype", "float32", "--device", "cpu",
         "--ckpt_root", str(tmp_path / "run"), *flags],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("suffix", [".ckpt", ".npz"])
def test_train_cli_takes_ckpt_and_bpe_vocab(suffix, files, loaded,
                                            tmp_path):
    """`--ckpt` takes a reference .ckpt or an .npz export; with a .ckpt,
    `--bpe_vocab` embeds the labels with its text tower. An .npz holds no
    text tower, so with `--bpe_vocab` it is refused by name."""
    ckpt, vocab = files
    flags = ["--ckpt", ckpt, "--bpe_vocab", vocab]
    if suffix == ".npz":
        (jvars, _), _ = loaded

        class State:
            params = jvars["params"]
            batch_stats = jvars["batch_stats"]

        npz = str(tmp_path / "w.npz")
        jckpt.export_params(npz, State())
        proc = _train(tmp_path, "--ckpt", npz, "--bpe_vocab", vocab)
        assert proc.returncode != 0 and "no text tower" in proc.stderr
        flags = ["--ckpt", npz]
    proc = _train(tmp_path, *flags)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert ("no text tower" in proc.stdout) == (suffix == ".npz")
    rows = (tmp_path / "run" / "lseg" / "metrics.csv").read_text()
    assert len(rows.splitlines()) > 1


# ---- the other backbones and heads, and the two transplant inits ----

def _rewrite(path, edit):
    """Load the lang-seg `.ckpt` at `path`, `edit(state_dict)` in place,
    save it back."""
    ck = torch.load(path, weights_only=True)
    edit(ck["state_dict"])
    torch.save(ck, path)


def _bn_keys(sd, key, c, rng):
    sd[f"{key}.weight"] = torch.from_numpy(
        (1 + 0.1 * rng.randn(c)).astype(np.float32))
    sd[f"{key}.bias"] = torch.from_numpy(0.1 * rng.randn(c).astype(
        np.float32))
    sd[f"{key}.running_mean"] = torch.from_numpy(
        0.1 * rng.randn(c).astype(np.float32))
    sd[f"{key}.running_var"] = torch.from_numpy(
        (1 + 0.1 * np.abs(rng.randn(c))).astype(np.float32))
    sd[f"{key}.num_batches_tracked"] = torch.tensor(7)


def _torchvision_blocks(sd, stage_prefix, layers, rng):
    """torchvision Bottleneck keys (conv1-3, bn1-3, the shortcut's
    downsample.0/1 on each stage's first block) at ResNet's widths."""
    def conv(key, o, i, k):
        sd[key] = torch.from_numpy(
            (rng.randn(o, i, k, k) * 0.05).astype(np.float32))

    cin = 64
    for s, n in enumerate(layers):
        p = 64 * 2 ** s
        for b in range(n):
            key = f"{stage_prefix(s)}.{b}"
            conv(f"{key}.conv1.weight", p, cin, 1)
            conv(f"{key}.conv2.weight", p, p, 3)
            conv(f"{key}.conv3.weight", 4 * p, p, 1)
            for c, w in ((1, p), (2, p), (3, 4 * p)):
                _bn_keys(sd, f"{key}.bn{c}", w, rng)
            if b == 0:
                conv(f"{key}.downsample.0.weight", 4 * p, cin, 1)
                _bn_keys(sd, f"{key}.downsample.1", 4 * p, rng)
            cin = 4 * p


def test_lseg_key_map_resnet101_equals_the_jax_path(tmp_path):
    """A lang-seg ResNet-101 checkpoint: `write_reference_ckpt`'s decoder
    and text tower, its ViT replaced by the repackaged torchvision stages
    (`pretrained.layer1` = (conv1, bn1, relu, maxpool, layer1), then
    `pretrained.layer2..4`) and the scratch's 3x3s widened to their
    channels. The port's loader equals the JAX package's `convert_lseg` +
    `from_jax_variables` bit for bit, and the state loads strictly into a
    ResNet-101 `LSegNet` (decoder width 32)."""
    from lseg_tpu.config import get_config as j_get_config

    cfg = dataclasses.replace(j_get_config("clip_resnet101", features=32),
                              out_c=64, text=TINY_TEXT)
    path = str(tmp_path / "rn.ckpt")
    write_reference_ckpt(path, tiny_vit_config())
    rng = np.random.RandomState(0)

    def edit(sd):
        for k in [k for k in sd if k.startswith("net.pretrained.")]:
            del sd[k]
        sd["net.pretrained.layer1.0.weight"] = torch.from_numpy(
            (rng.randn(64, 3, 7, 7) * 0.05).astype(np.float32))
        _bn_keys(sd, "net.pretrained.layer1.1", 64, rng)
        _torchvision_blocks(
            sd, lambda s: "net.pretrained.layer1.4" if s == 0
            else f"net.pretrained.layer{s + 1}", cfg.resnet.layers, rng)
        for i in range(4):
            sd[f"net.scratch.layer{i + 1}_rn.weight"] = torch.from_numpy(
                (rng.randn(32, 256 * 2 ** i, 3, 3) * 0.05).astype(
                    np.float32))

    _rewrite(path, edit)
    (jvars, jtext), (state, text) = j_load(path, cfg), \
        load_reference_checkpoint(path, cfg)
    assert "resnet" in jvars["batch_stats"]
    _assert_same(state, from_jax_variables(jvars))
    _assert_same(text, from_jax_text_params(jtext["params"]))
    LSegNet(cfg).load_state_dict(state, strict=True)


@pytest.mark.parametrize("option", [1, 2])
def test_lseg_key_map_head_block_equals_the_jax_path(option, tmp_path):
    """An arch_option checkpoint: `write_reference_ckpt` plus the head
    block's shared depthwise 3x3 (`scratch.head_block.depthwise.
    depthwise`, (1, 1, 3, 3) and (1,)), loaded as the JAX package loads
    it, bit for bit, and strictly into the port's model."""
    cfg = tiny_vit_config(arch_option=option, block_depth=2)
    path = str(tmp_path / "arch.ckpt")
    write_reference_ckpt(path, cfg)
    key = "net.scratch.head_block.depthwise.depthwise"

    def edit(sd):
        sd[f"{key}.weight"] = torch.randn(1, 1, 3, 3)
        sd[f"{key}.bias"] = torch.randn(1)

    _rewrite(path, edit)
    (jvars, _), (state, _) = j_load(path, cfg), load_reference_checkpoint(
        path, cfg)
    _assert_same(state, from_jax_variables(jvars))
    assert state["head_block.weight"].shape == (1, 1, 3, 3)
    LSegNet(cfg).load_state_dict(state, strict=True)


@pytest.mark.parametrize("width", [640, 768])
def test_loader_at_rn50x_text_widths(width, tmp_path):
    """The lang-seg loader at RN50x4's and RN50x16's text widths (head1
    and the text tower at E = 640 / 768), bit for bit the JAX path."""
    cfg = tiny_vit_config(text=tiny_text_config(width), out_c=width)
    path = str(tmp_path / f"w{width}.ckpt")
    write_reference_ckpt(path, cfg)
    (jvars, jtext), (state, text) = j_load(path, cfg), \
        load_reference_checkpoint(path, cfg)
    _assert_same(state, from_jax_variables(jvars))
    _assert_same(text, from_jax_text_params(jtext["params"]))
    assert text["text_projection"].shape == (width, width)


def _unprefixed(state, prefix):
    return {k[len(prefix):]: t for k, t in state.items()}


@pytest.mark.parametrize("layers,prefix", [((1, 1, 1, 1), ""),
                                           ((2, 1, 2, 1), "backbone.")])
def test_torchvision_resnet_key_map_equals_jax(layers, prefix):
    """`torchvision_resnet_key_map` equals the JAX package's
    `convert_torchvision_resnet` + `from_jax_variables` bit for bit
    (torchvision's `num_batches_tracked` and `fc` dropped), and loads
    strictly into `ResNetBackbone`."""
    from lseg_tpu.config import ResNetConfig
    from lseg_tpu.utils.checkpoint_convert import (
        convert_torchvision_resnet,
    )
    from lseg_tpu_torch.models.resnet import ResNetBackbone

    rng = np.random.RandomState(1)
    tsd = {f"{prefix}conv1.weight": torch.from_numpy(
        (rng.randn(64, 3, 7, 7) * 0.05).astype(np.float32))}
    _bn_keys(tsd, f"{prefix}bn1", 64, rng)
    _torchvision_blocks(tsd, lambda s: f"{prefix}layer{s + 1}", layers, rng)
    tsd[f"{prefix}fc.weight"] = torch.randn(10, 2048)
    sd = {k: t.numpy() for k, t in tsd.items()}
    p, s = convert_torchvision_resnet(sd, layers, prefix)
    want = _unprefixed(from_jax_variables(
        {"params": {"resnet": p}, "batch_stats": {"resnet": s}}), "resnet.")
    got = apply_key_map(sd, torchvision_resnet_key_map(sd, layers, prefix))
    _assert_same(got, want)
    ResNetBackbone(ResNetConfig(layers)).load_state_dict(got, strict=True)


@pytest.mark.parametrize("grid_match", [True, False])
def test_clip_visual_key_map_equals_jax(grid_match):
    """`clip_visual_key_map` on a CLIP ViT-B/32-shaped visual tower
    equals the JAX package's `convert_clip_visual_to_vit` +
    `from_jax_variables` bit for bit: class_embedding, conv1 (zero bias),
    in_proj, the MLP, and the position embedding where the grids agree
    (left out, as the reference leaves it, where they do not)."""
    from lseg_tpu.utils.checkpoint_convert import convert_clip_visual_to_vit
    from lseg_tpu_torch.models.vit import DenseViT

    cfg = tiny_vitb_config(32)
    vit = cfg.vit
    d, p = vit.embed_dim, vit.patch_size
    g = vit.pretrain_grid if grid_match else vit.pretrain_grid + 4
    rng = np.random.RandomState(2)
    pre = "clip_pretrained.visual"

    def t(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)

    sd = {f"{pre}.class_embedding": t(d), f"{pre}.conv1.weight": t(d, 3, p, p),
          f"{pre}.positional_embedding": t(1 + g * g, d),
          f"{pre}.ln_pre.weight": t(d), f"{pre}.proj": t(d, 64)}
    for i in range(vit.depth):
        b = f"{pre}.transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = 1 + t(d), t(d)
        sd[f"{b}.attn.in_proj_weight"] = t(3 * d, d)
        sd[f"{b}.attn.in_proj_bias"] = t(3 * d)
        sd[f"{b}.attn.out_proj.weight"] = t(d, d)
        sd[f"{b}.attn.out_proj.bias"] = t(d)
        sd[f"{b}.mlp.c_fc.weight"], sd[f"{b}.mlp.c_fc.bias"] = (
            t(4 * d, d), t(4 * d))
        sd[f"{b}.mlp.c_proj.weight"], sd[f"{b}.mlp.c_proj.bias"] = (
            t(d, 4 * d), t(d))
    want = _unprefixed(from_jax_variables(
        {"params": {"vit": convert_clip_visual_to_vit(sd, cfg)}}), "vit.")
    got = apply_key_map(sd, clip_visual_key_map(sd, cfg))
    _assert_same(got, want)
    assert ("pos_embed" in got) == grid_match
    missing, unexpected = DenseViT(vit).load_state_dict(got, strict=False)
    assert unexpected == [] and missing == ([] if grid_match
                                            else ["pos_embed"])

