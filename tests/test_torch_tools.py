"""The port's remaining entry points and tools against the JAX package's:
the fp16-emulated correlation and `LSegNet(emulate_fp16=True)`,
`encode_labels`, `fold_bn_tree` on the ViT and ResNet configs of
`tests/test_fold_bn.py`, the `Logger` and its parameter count,
`StepTimer`, `trace`, and the `demo`, `parity_check` and `app` functions
on a tiny config registered in place of `get_config` (features 32, the
CLIP context of 77 that the JAX demo's tokenizer uses).

Tolerances, each beside the error measured on the CPU:
- `correlate(emulate_fp16=True)`: within 2e-6 at the logit scale 1/0.07
  (the same exact fp16 products summed in fp32 in another order;
  measured 8.9e-7); an fp16-output product strays ~1e-2;
- `LSegNet(emulate_fp16=True)` fp32 logits: the embeddings agree to fp32
  reordering, and a component that crosses an fp16 rounding boundary
  moves a logit by up to an fp16 ulp at the scale: >= 0.98 of the logits
  within 1e-4 (measured 0.9907) and all within 2^-10 / 0.07 (measured
  7.3e-4); an fp16-output product moves most logits by more than 1e-4;
- `encode_labels`: rtol 1e-4, atol 1e-5 (measured 1.9e-6);
- `fold_bn_tree`: the folded state within 1e-6 of JAX's folded tree
  (measured 3.0e-8), the folded model's logits within 1e-4 of the
  unfolded model's, as `tests/test_fold_bn.py` holds JAX's (measured
  3.8e-6);
- the demo's overlay from a reference `.ckpt` against JAX's `demo.py` on
  the same file: bf16 forwards of two packages, so labels may flip at
  near-ties: >= 0.98 of the pixels equal (measured 0.9928), the legends
  equal;
- `parity_check` against JAX's fp32 emulate_fp16 logits: PASS (its own
  bounds, 5e-2 and 0.999), the max difference within 2^-10 / 0.07 as the
  model's (measured 4.4e-4).
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_parity import perturb, seeded_variables

import lseg_tpu.config as jconfig
import lseg_tpu_torch
from lseg_tpu.models.clip_text import CLIPTextEncoder as JText
from lseg_tpu.models.lseg import LSegNet as JNet
from lseg_tpu.ops.correlation import correlate as j_correlate
from lseg_tpu.testing import tiny_rn_config as j_tiny_rn
from lseg_tpu.testing import tiny_vit_config as j_tiny_vit
from lseg_tpu.testing import write_reference_ckpt, write_reference_vocab
from lseg_tpu.text.cache import encode_labels as j_encode_labels
from lseg_tpu.utils.fold_bn import fold_bn_tree as j_fold
from lseg_tpu.utils.logging import Logger as JLogger
from lseg_tpu_torch import app, demo, parity_check
from lseg_tpu_torch.config import CLIPTextConfig
from lseg_tpu_torch.models.layers import random_init_
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.ops.correlation import correlate
from lseg_tpu_torch.testing import TINY_TEXT, tiny_vit_config
from lseg_tpu_torch.text.cache import encode_labels
from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer
from lseg_tpu_torch.utils import profiling
from lseg_tpu_torch.utils.convert import (
    from_jax_text_params,
    from_jax_variables,
    to_jax_variables,
)
from lseg_tpu_torch.utils.fold_bn import fold_bn_tree
from lseg_tpu_torch.utils.logging import Logger

LOGIT_ATOL = 1e-4
FP16_ULP_1 = 2.0 ** -10  # fp16's spacing just below 1, twice
MIN_WITHIN = 0.98
EMULATE_ATOL = 2e-6
FOLD_ATOL = 1e-6
MIN_EQUAL = 0.98
LABELS = "cat,grass,stone,other"
# the JAX demo tokenizes at CLIP's context of 77
TEXT_77 = CLIPTextConfig(vocab_size=1024, context_length=77, width=32,
                         layers=2, heads=2, embed_dim=64)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- emulate_fp16 ----------------------------------------------------


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_correlate_emulate_fp16(compute_dtype):
    rng = np.random.RandomState(0)
    img = rng.randn(2, 5, 6, 64).astype(np.float32)
    txt = rng.randn(4, 64).astype(np.float32)
    got = correlate(_t(img), _t(txt), emulate_fp16=True,
                    compute_dtype=getattr(torch, compute_dtype),
                    defer_pixel_norm=compute_dtype == "bfloat16")
    ref = j_correlate(jnp.asarray(img), jnp.asarray(txt), emulate_fp16=True,
                      compute_dtype=getattr(jnp, compute_dtype),
                      defer_pixel_norm=compute_dtype == "bfloat16")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=EMULATE_ATOL)
    # the plain fp32 head differs by more than the tolerance: the test
    # sees the fp16 operands
    plain = correlate(_t(img), _t(txt)).numpy()
    assert np.abs(plain - np.asarray(ref)).max() > 10 * EMULATE_ATOL


def test_lsegnet_emulate_fp16_matches_jax():
    cfg = j_tiny_vit()
    v = seeded_variables(cfg)
    rng = np.random.RandomState(1)
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    txt = rng.randn(4, cfg.out_c).astype(np.float32)
    ref = jax.jit(JNet(cfg, emulate_fp16=True).apply)(
        v, jnp.asarray(x), jnp.asarray(txt))
    model = LSegNet(tiny_vit_config(), emulate_fp16=True)
    model.load_state_dict(from_jax_variables(v))
    with torch.no_grad():
        got = model(_t(x), _t(txt)).numpy()
    err = np.abs(got - np.asarray(ref))
    # the embeddings agree to fp32 reordering, which can move a component
    # across an fp16 rounding boundary: a logit then moves by an fp16 ulp
    # of a unit component times the scale
    assert err.max() <= cfg.logit_scale * FP16_ULP_1, err.max()
    assert (err <= LOGIT_ATOL).mean() >= MIN_WITHIN, (err <= LOGIT_ATOL).mean()


# --- text ------------------------------------------------------------


def test_encode_labels_matches_jax():
    labels = ["the cat", "dog", "other", "grass and stone"]
    tok = ClipBPETokenizer.for_tests(TINY_TEXT.context_length)
    v = perturb(JText(TINY_TEXT).init(jax.random.PRNGKey(0), jnp.asarray(
        tok(labels))))
    ref = j_encode_labels(TINY_TEXT, v, tok, labels)
    got = encode_labels(TINY_TEXT, from_jax_text_params(v["params"]), tok,
                        labels)
    assert isinstance(got, np.ndarray) and got.shape == (4, 64)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


# --- fold_bn ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["vit", "resnet"])
def test_fold_bn_tree_matches_jax(kind):
    """The folded state equals JAX's folded tree; it loads into a
    `use_bn=False` model whose logits equal the unfolded model's. The
    ResNet keeps its backbone's BatchNorms (no `use_bn` switch), as the
    JAX test folds only the decoder's statistics."""
    jcfg = j_tiny_vit() if kind == "vit" else j_tiny_rn()
    v = seeded_variables(jcfg, seed=3)
    keep = () if kind == "vit" else ("resnet.",)
    stats = {k: s for k, s in v["batch_stats"].items() if k != "resnet"}
    jfolded = {"params": j_fold(v["params"], stats)}
    if kind == "resnet":
        jfolded["batch_stats"] = {"resnet": v["batch_stats"]["resnet"]}
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, jfolded))

    cfg = dataclasses.replace(jcfg, use_bn=True)
    model = LSegNet(cfg)
    state = from_jax_variables(v)
    model.load_state_dict(state)
    folded = fold_bn_tree(state, keep=keep)
    assert folded.keys() == want.keys()
    for k in folded:
        np.testing.assert_allclose(folded[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=FOLD_ATOL, err_msg=k)
    plain = LSegNet(dataclasses.replace(cfg, use_bn=False))
    plain.load_state_dict(folded)
    rng = np.random.RandomState(2)
    x = _t(rng.randn(1, 64, 64, 3).astype(np.float32))
    txt = _t(rng.randn(3, cfg.out_c).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(plain(x, txt).numpy(),
                                   model(x, txt).numpy(), rtol=1e-4,
                                   atol=LOGIT_ATOL)


# --- logging and profiling -------------------------------------------


def test_logger_and_count_params(tmp_path, capsys):
    cfg = j_tiny_rn()
    model = random_init_(LSegNet(cfg), torch.Generator().manual_seed(0))
    v = to_jax_variables({k: t.clone() for k, t in
                          model.state_dict().items()})
    assert Logger.count_params(model) == JLogger.count_params(v["params"])
    assert Logger.count_params(model.state_dict()) == (
        JLogger.count_params(v["params"])
        + JLogger.count_params(v["batch_stats"]))
    log = Logger(str(tmp_path), "run")
    log.log_args(type("A", (), {"__dict__": {"lr": 0.1, "bsz": 2}})())
    saved = []
    assert log.save_model_miou(saved.append, 1, 40.0)
    assert not log.save_model_miou(saved.append, 2, 30.0)
    assert saved == [str(tmp_path / "run" / "best_model.npz")]
    text = (tmp_path / "run" / "log.txt").read_text()
    assert "| bsz: 2" in text and "model saved @1 w/ val. mIoU: 40.00" in text
    assert text.count("\n") == len(capsys.readouterr().out.splitlines())


def test_step_timer_trace_and_memory(tmp_path):
    t = profiling.StepTimer(warmup=1)
    x = torch.ones(64, 64)
    assert t.step(x @ x) is None
    assert t.step({"y": [x @ x]}) > 0
    assert t.mean > 0 and t.throughput(8) > 0
    with profiling.trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    assert prof is not None
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


# --- demo, parity_check, app -----------------------------------------


def _tiny_cfg(pkg_tiny):
    return pkg_tiny(features=32, text=TEXT_77)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A reference `.ckpt` of the tiny config at CLIP's context, its
    vocabulary and a 70 x 90 RGB image."""
    root = tmp_path_factory.mktemp("tools")
    ckpt, vocab = str(root / "ref.ckpt"), str(root / "bpe.txt.gz")
    write_reference_ckpt(ckpt, _tiny_cfg(j_tiny_vit))
    write_reference_vocab(vocab)
    img = str(root / "image.png")
    rng = np.random.RandomState(0)
    low = rng.randint(0, 255, (7, 9, 3)).astype(np.uint8)
    Image.fromarray(low).resize((90, 70), Image.BILINEAR).save(img)
    return ckpt, vocab, img


@pytest.fixture
def tiny_backbone(monkeypatch):
    """`get_config` of both packages returns the tiny config, whatever
    the backbone's name (the CLIs read it at call time)."""
    monkeypatch.setattr(lseg_tpu_torch, "get_config",
                        lambda name, **kw: _tiny_cfg(tiny_vit_config))
    monkeypatch.setattr(jconfig, "get_config",
                        lambda name, **kw: _tiny_cfg(j_tiny_vit))


def _demo(files, tmp_path, *extra):
    _, _, img = files
    out = str(tmp_path / "out.png")
    pred = demo.main(["--image", img, "--labels", LABELS, "--out", out,
                      "--device", "cpu"] + list(extra))
    return pred, np.asarray(Image.open(out))


@pytest.mark.parametrize("flags", [[], ["--fast"], ["--fast", "--int8"]],
                         ids=["default", "fast", "fast_int8"])
def test_demo_smoke_mode(files, tmp_path, tiny_backbone, capsys, flags):
    """`--weights random` at the app shape: labels at 360 x 480 within the
    label set, the overlay saved, the legend of the labels present."""
    pred, overlay = _demo(files, tmp_path, "--weights", "random", *flags)
    out = capsys.readouterr().out
    assert out.startswith("SMOKE MODE")
    assert pred.shape == (360, 480) and overlay.shape == (360, 480, 3)
    assert 0 <= pred.min() and pred.max() < 4
    names = LABELS.split(",")
    legend = [ln.split(":")[0].strip() for ln in out.splitlines()
              if ln.startswith("  ")]
    assert legend == [names[c] for c in np.unique(pred)]
    with pytest.raises(SystemExit, match="--int8 requires --fast"):
        _demo(files, tmp_path, "--weights", "random", "--int8")


def test_demo_from_ckpt_matches_jax_demo(files, tmp_path, tiny_backbone,
                                         monkeypatch, capsys):
    """The demo on a reference `.ckpt`: the port's overlay against the
    JAX package's `demo.py` on the same file, image and labels."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "jax_demo", Path(__file__).resolve().parent.parent / "demo.py")
    jdemo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdemo)
    ckpt, vocab, _ = files
    _, got = _demo(files, tmp_path, "--weights", ckpt, "--bpe_vocab",
                   vocab)
    port_legend = capsys.readouterr().out.splitlines()[1:]
    jout = str(tmp_path / "jax.png")
    monkeypatch.setattr(sys, "argv", [
        "demo.py", "--image", files[2], "--labels", LABELS, "--weights",
        ckpt, "--bpe_vocab", vocab, "--out", jout])
    jdemo.main()
    jax_legend = capsys.readouterr().out.splitlines()[1:]
    want = np.asarray(Image.open(jout))
    assert got.shape == want.shape == (360, 480, 3)
    equal = float(np.all(got == want, axis=-1).mean())
    assert equal >= MIN_EQUAL, equal
    assert port_legend == jax_legend


def test_parity_check_against_jax_logits(files, tmp_path, tiny_backbone,
                                         capsys):
    """`python -m lseg_tpu_torch.parity_check` on logits written by the
    JAX package's fp32 `LSegNet(emulate_fp16=True)` from the same
    `.ckpt` (NCHW input and NKHW logits, as lang-seg dumps them): PASS;
    the same logits moved by 0.1: INSPECT."""
    from lseg_tpu.text.cache import TextFeatureCache as JCache
    from lseg_tpu.text.tokenizer import ClipBPETokenizer as JTok
    from lseg_tpu.utils.checkpoint_convert import (
        load_reference_checkpoint as j_load,
    )

    ckpt, vocab, _ = files
    cfg = _tiny_cfg(j_tiny_vit)
    variables, text_vars = j_load(ckpt, cfg)
    labels = LABELS.split(",")
    txt = JCache(cfg.text, text_vars, JTok.from_file(vocab))(tuple(labels))
    x = np.random.RandomState(3).randn(1, 64, 96, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(JNet(cfg, emulate_fp16=True).apply)(
            variables, jnp.asarray(x), txt))
    paths = {k: str(tmp_path / f"{k}.npy") for k in ("x", "ref", "moved")}
    np.save(paths["x"], x.transpose(0, 3, 1, 2))
    np.save(paths["ref"], ref.transpose(0, 3, 1, 2))
    np.save(paths["moved"], ref.transpose(0, 3, 1, 2) + 0.1)
    argv = ["--weights", ckpt, "--bpe_vocab", vocab, "--ref_input",
            paths["x"], "--labels", LABELS, "--device", "cpu"]
    assert parity_check.main(argv + ["--ref_logits", paths["ref"]])
    out = capsys.readouterr().out
    assert out.strip().endswith("PARITY: PASS")
    diff = float(out.split("max abs diff :")[1].split()[0])
    assert diff <= cfg.logit_scale * FP16_ULP_1, diff
    assert not parity_check.main(argv + ["--ref_logits", paths["moved"]])
    assert "PARITY: INSPECT" in capsys.readouterr().out


def test_app_load_and_request(files, tmp_path, tiny_backbone, capsys):
    """The app's `load` and `request` without Streamlit: a single-scale
    request gives the demo's overlay and legend for the same file, a TTA
    request labels the image at its own size."""
    assert "streamlit" not in sys.modules
    ckpt, vocab, img = files
    loaded = app.load(ckpt, vocab, "tiny", device="cpu")
    overlay, legend = app.request(loaded, img, " cat, grass ,stone,other ")
    pred, want = _demo(files, tmp_path, "--weights", ckpt, "--bpe_vocab",
                       vocab)
    assert np.array_equal(overlay, want)
    printed = capsys.readouterr().out.splitlines()[1:]
    assert [f"  {n}: rgb{c}" for n, c in legend] == printed
    overlay, legend = app.request(loaded, Image.open(img), LABELS,
                                  use_tta=True, alpha=0.3)
    assert overlay.shape == (70, 90, 3) and overlay.dtype == np.uint8
    assert {n for n, _ in legend} <= set(LABELS.split(","))
    assert "streamlit" not in sys.modules
