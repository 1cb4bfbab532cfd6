"""The port's reference-checkpoint loader, text tower loading and `.npz`
export / import against the JAX package's, on files written by the JAX
package's `write_reference_ckpt` / `write_reference_vocab` at the tiny
config's widths; and the training CLI's `--ckpt` / `--bpe_vocab`."""

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
from torch_parity import jax_lseg_variables, tiny_parity_config

from lseg_tpu.models.lseg import LSegNet as JNet
from lseg_tpu.ops.quant import quantize_tree as j_quantize_tree
from lseg_tpu.testing import (
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
    extract_state_dict,
    load_reference_checkpoint,
    load_torch_file,
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
    cfg = tiny_parity_config()
    return _jax_int8_tree(cfg), fast_serving(cfg, "static_cal")


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(a)
            for k, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_jax_npz_export_imports_into_the_port(kind, loaded, tmp_path):
    jvars, _ = _trees(kind, loaded)

    class State:
        params = jvars["params"]
        batch_stats = jvars["batch_stats"]

    path = str(tmp_path / "jax.npz")
    jckpt.export_params(path, State())
    _assert_same(tckpt.import_params(path), from_jax_variables(jvars))


@pytest.mark.parametrize("kind", ["float", "int8"])
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
