"""The port's few-shot data and evaluation path against the JAX package's:
the episode meters, the seed helper, the native decode route, the
PASCAL-5i / COCO-20i / FSS-1000 episodes, the visualizer, the pair
features, the episodic evaluator and `python -m lseg_tpu_torch.test_zs`
(its flags, its log line beside JAX's `test_zs.py`, and no silent CPU).

Tolerances: the meters, the datasets, the native route and the
visualizer are exact (bit for bit); the pair features fp32 within 1e-5;
the evaluator, in fp32 on both sides, within 1e-6 of JAX's metrics; the
command line, in bf16 on both sides as `test_zs.py` runs, prints the
same line to its two decimals."""

import dataclasses
import importlib.util
import os
import random
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_parity import (  # noqa: F401  (native_libs is a fixture)
    f32,
    native_libs,
    perturb,
    write_coco_tree,
    write_fss_tree,
    write_voc_tree,
)

from lseg_tpu.data import fewshot as jfewshot
from lseg_tpu.data import native as jnative
from lseg_tpu.ops import metrics as jmetrics
from lseg_tpu.testing import TINY_TEXT
from lseg_tpu.utils import fewshot_vis as jvis
from lseg_tpu_torch.data import fewshot as tfewshot
from lseg_tpu_torch.data import native as tnative
from lseg_tpu_torch.ops import metrics as tmetrics
from lseg_tpu_torch.utils import fewshot_vis as tvis
from lseg_tpu_torch.utils.seed import fix_randseed

REPO = Path(__file__).resolve().parents[1]


# --- meters -----------------------------------------------------------


def _episode_stream(seed=0, batches=6, n=3, h=9, w=11, ncls=5):
    """Seeded binary predictions and targets with ignore regions, and
    class ids drawn with repeats."""
    rng = np.random.RandomState(seed)
    for _ in range(batches):
        pred = rng.randint(0, 2, (n, h, w)).astype(np.int32)
        tgt = rng.randint(0, 2, (n, h, w)).astype(np.int32)
        ign = rng.rand(n, h, w) < 0.2
        ign[0, :2] = True  # a rim, as PASCAL's 255 border
        yield pred, tgt, ign, rng.randint(0, ncls, n)


def test_episode_inter_union_matches_jax():
    for pred, tgt, ign, _ in _episode_stream():
        ri, ru = jmetrics.episode_inter_union(
            jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(ign))
        gi, gu = tmetrics.episode_inter_union(
            torch.from_numpy(pred), torch.from_numpy(tgt),
            torch.from_numpy(ign))
        assert gi.dtype == gu.dtype == torch.float32
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gu.numpy(), np.asarray(ru))


def test_episode_inter_union_folds_ignore():
    """The ignored pixel (0, 1) counts for neither class: fg inter 1,
    union 1; bg inter 2, union 2 (JAX's own case)."""
    pred = torch.tensor([[[1, 1], [0, 0]]])
    tgt = torch.tensor([[[1, 0], [0, 0]]])
    ign = torch.tensor([[[False, True], [False, False]]])
    inter, union = tmetrics.episode_inter_union(pred, tgt, ign)
    assert inter.tolist() == [[2.0, 1.0]] and union.tolist() == [[2.0, 1.0]]


def test_average_meter_matches_jax():
    """The same stream of areas and repeated class ids: the float64
    buffers, mIoU and FB-IoU equal JAX's exactly."""
    class_ids = [0, 2, 3, 4]
    ref, got = jmetrics.AverageMeter(class_ids), tmetrics.AverageMeter(
        class_ids)
    for pred, tgt, ign, cid in _episode_stream(1, ncls=5):
        ri, ru = jmetrics.episode_inter_union(
            jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(ign))
        cid = np.where(np.isin(cid, class_ids), cid, 2)
        ref.update(np.asarray(ri), np.asarray(ru), cid, loss=0.5)
        got.update(np.asarray(ri), np.asarray(ru), cid, loss=0.5)
    assert got.inter.dtype == np.float64
    np.testing.assert_array_equal(got.inter, ref.inter)
    np.testing.assert_array_equal(got.union, ref.union)
    assert (got.loss_sum, got.count) == (ref.loss_sum, ref.count)
    assert got.compute_iou() == ref.compute_iou()
    # FB-IoU is the ratio of sums, which the mean of ratios is not
    miou, fb = got.compute_iou()
    sel = np.asarray(class_ids)
    mean_of_ratios = 100 * np.mean(got.inter[:, sel] / got.union[:, sel])
    assert abs(fb - mean_of_ratios) > 1e-6


def test_fix_randseed_seeds_the_host_rngs():
    g = fix_randseed(5)
    a = (random.random(), np.random.rand(), torch.rand(2, generator=g))
    g = fix_randseed(5)
    b = (random.random(), np.random.rand(), torch.rand(2, generator=g))
    assert a[:2] == b[:2] and torch.equal(a[2], b[2])
    from lseg_tpu.utils.seed import fix_randseed as j_fix

    j_fix(5)
    assert (random.random(), np.random.rand()) == a[:2]


# --- the native route and the datasets --------------------------------


def test_native_matches_jax(native_libs, tmp_path):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (37, 53, 3), np.uint8)
    mask = rng.randint(0, 200, (37, 53)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "a.jpg", quality=90)
    Image.fromarray(img).save(tmp_path / "a.png")
    Image.fromarray(mask).save(tmp_path / "m.png")
    for path, m in (("a.jpg", False), ("a.png", False), ("m.png", True)):
        ref = jnative.decode(str(tmp_path / path), mask=m)
        got = tnative.decode(str(tmp_path / path), mask=m)
        assert (got is None) == (ref is None) == (not native_libs)
        if ref is not None:
            np.testing.assert_array_equal(got, ref)
    for hw in ((37, 53), (48, 64), (20, 30)):
        ref = jnative.load_image_f32(str(tmp_path / "a.jpg"), hw,
                                     (0.5,) * 3, (0.5,) * 3)
        got = tnative.load_image_f32(str(tmp_path / "a.jpg"), hw,
                                     (0.5,) * 3, (0.5,) * 3)
        if ref is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, ref)
    for oh, ow in ((64, 64), (20, 31)):
        np.testing.assert_array_equal(
            tnative.resize_nearest_i32(mask, oh, ow),
            jnative.resize_nearest_i32(mask, oh, ow))


def _assert_episode_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        g, r = got[k], ref[k]
        if isinstance(r, np.ndarray):
            assert g.dtype == r.dtype and g.shape == r.shape, k
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            assert type(g) is type(r) and g == r, k


def _tree(kind, root):
    if kind == "pascal":
        return write_voc_tree(root, {0: ["a0", "a1", "a2"], 1: ["b0", "b1"],
                                     3: ["d0", "d1"]})
    if kind == "coco":
        return write_coco_tree(root, [0, 4, 8])
    return write_fss_tree(root, ["ant", "bee"])


@pytest.mark.parametrize("kind,shot,imagenet", [
    ("pascal", 0, False), ("pascal", 1, True), ("pascal", 2, False),
    ("coco", 1, False), ("coco", 0, True), ("fss", 1, False),
    ("fss", 2, True)])
def test_episodes_match_jax(native_libs, tmp_path, kind, shot, imagenet):
    """Key by key and bit for bit, at indices that wrap past the
    metadata (PASCAL) and that draw COCO's per-episode class."""
    datapath, splits = _tree(kind, tmp_path)
    kw = dict(splits_dir=splits, img_size=48, imagenet_norm=imagenet,
              seed=3)
    ref = jfewshot.build_fewshot_dataset(kind, datapath, 0, "test", shot,
                                         **kw)
    got = tfewshot.build_fewshot_dataset(kind, datapath, 0, "test", shot,
                                         **kw)
    if kind == "coco":  # the tree holds 3 of the fold's 20 classes
        ref.class_ids = got.class_ids = [0, 4, 8]
    assert len(got) == len(ref) and got.class_ids == ref.class_ids
    for i in sorted({i % len(ref) for i in (0, 1, 5, 7, len(ref) - 1)}):
        _assert_episode_equal(got[i], ref[i])


def test_episode_batch_stacks_as_the_evaluator_reads_it(native_libs,
                                                        tmp_path):
    datapath, splits = _tree("pascal", tmp_path)
    ds = tfewshot.DatasetPASCAL(datapath, 0, "test", 1, splits,
                                img_size=32)
    eps = [ds[i] for i in range(3)]
    assert np.stack([e["query_img"] for e in eps]).shape == (3, 32, 32, 3)
    assert all(e["query_ignore"].any() for e in eps)
    assert ds.class_ids == [0, 1, 2, 3, 4] and len(ds) == 1000


def test_visualizer_matches_jax(native_libs, tmp_path):
    datapath, splits = _tree("pascal", tmp_path)
    ds = tfewshot.DatasetPASCAL(datapath, 0, "test", 2, splits,
                                img_size=32)
    eps = [ds[i] for i in range(2)]
    batch = {k: np.stack([e[k] for e in eps]) for k in (
        "support_imgs", "support_masks", "query_img", "query_mask")}
    pred = np.random.RandomState(0).randint(0, 2, (2, 32, 32))
    outs = {}
    for name, mod in (("jax", jvis), ("port", tvis)):
        vis = mod.EpisodeVisualizer(str(tmp_path / name))
        outs[name] = vis.batch(batch, pred, [0, 3], 4, ious=[0.25, 0.5])
    assert [os.path.basename(p) for p in outs["port"]] == [
        os.path.basename(p) for p in outs["jax"]]
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                      np.asarray(Image.open(b)))
    rng = np.random.RandomState(1)
    img = rng.randn(5, 6, 3).astype(np.float32)
    m = rng.randint(0, 2, (5, 6))
    np.testing.assert_array_equal(
        tvis.apply_mask(tvis.unnormalize(img, 0.5, 0.5), m, (1, 2, 3)),
        jvis.apply_mask(jvis.unnormalize(img, 0.5, 0.5), m, (1, 2, 3)))


# --- pair features, the evaluator, the command line -------------------


def test_pair_features_match_jax():
    from lseg_tpu.models.clip_text import CLIPTextEncoder as JText
    from lseg_tpu.text.cache import TextFeatureCache as JCache
    from lseg_tpu.text.tokenizer import ClipBPETokenizer as JTok
    from lseg_tpu_torch.text.cache import TextFeatureCache
    from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer
    from lseg_tpu_torch.utils.convert import from_jax_text_params

    n = TINY_TEXT.context_length
    jv = perturb(JText(TINY_TEXT).init(
        jax.random.PRNGKey(0), jnp.zeros((2, n), jnp.int32)))
    state = from_jax_text_params(jv["params"])
    ref = JCache(TINY_TEXT, jv, JTok.for_tests(n))
    got = TextFeatureCache(TINY_TEXT, state, ClipBPETokenizer.for_tests(n),
                           device="cpu")
    for label in ("cat", "aeroplane", "potted plant"):
        g = got.pair_features(label)
        assert g.shape == (2, TINY_TEXT.embed_dim)
        np.testing.assert_allclose(g.numpy(), f32(ref.pair_features(label)),
                                   rtol=1e-5, atol=1e-5)
        assert got.pair_features(label) is g  # cached
    assert torch.equal(got.pair_features("cat", other="background"),
                       got(("background", "cat")))


@pytest.fixture(scope="module")
def tiny_model():
    """The tiny ViT config's perturbed JAX variables and the same weights
    in the port."""
    from torch_parity import seeded_variables

    from lseg_tpu.testing import tiny_vit_config
    from lseg_tpu_torch.utils.convert import from_jax_variables

    cfg = tiny_vit_config()
    v = seeded_variables(cfg)
    return cfg, v, from_jax_variables(v)


class _Slice:
    """The first `n` episodes of a dataset."""

    def __init__(self, ds, n):
        self.ds, self.n, self.class_ids = ds, n, ds.class_ids

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i]


def test_episodic_evaluator_matches_jax(native_libs, tmp_path, tiny_model):
    """A 4-episode slice of a 1-shot PASCAL tree in fp32 on both sides:
    mIoU and FB-IoU within 1e-6 of JAX's, and the visualizer's composites
    the same files with the same pixels."""
    from lseg_tpu.engine.episodic import EpisodicEvaluator as JEval
    from lseg_tpu.engine.episodic import make_episodic_predictor as jpred
    from lseg_tpu.models.lseg import LSegNet as JNet
    from lseg_tpu_torch.engine import (
        EpisodicEvaluator,
        make_episodic_predictor,
    )
    from lseg_tpu_torch.models.lseg import LSegNet

    cfg, v, sd = tiny_model
    datapath, splits = _tree("pascal", tmp_path)
    kw = dict(splits_dir=splits, img_size=64)
    jds = _Slice(jfewshot.DatasetPASCAL(datapath, 0, "test", 1, **kw), 4)
    tds = _Slice(tfewshot.DatasetPASCAL(datapath, 0, "test", 1, **kw), 4)
    rng = np.random.RandomState(4)
    pairs = {c: rng.randn(2, cfg.out_c).astype(np.float32)
             for c in range(5)}
    jv = jvis.EpisodeVisualizer(str(tmp_path / "jax"))
    ref = JEval(jpred(JNet(cfg), v), jds.class_ids, visualizer=jv).run(
        jds, lambda c: pairs[c], batch_size=3, log=lambda *_: None)
    model = LSegNet(cfg, torch.float32)
    model.load_state_dict(sd)
    logs = []
    tv = tvis.EpisodeVisualizer(str(tmp_path / "port"))
    got = EpisodicEvaluator(make_episodic_predictor(model), tds.class_ids,
                            visualizer=tv).run(
        tds, lambda c: torch.from_numpy(pairs[c]), batch_size=3,
        log=logs.append, log_every=1)
    print(f"port {got} jax {ref}")
    assert len(logs) == 2 and logs[-1].startswith("[4/4] mIoU")
    assert abs(got[0] - ref[0]) <= 1e-6 and abs(got[1] - ref[1]) <= 1e-6
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == 4
    for name in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / name)),
            np.asarray(Image.open(tmp_path / "jax" / name)))


def _jax_test_zs():
    spec = importlib.util.spec_from_file_location("jax_test_zs",
                                                  REPO / "test_zs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(parser_fn, argv):
    """{option: (default, type, choices, required)} of an argparse CLI,
    read by capturing the parser it builds."""
    import argparse

    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        return orig(self, args, namespace)

    argparse.ArgumentParser.parse_args = capture
    old_argv = sys.argv
    sys.argv = ["prog", *argv]
    try:
        parser_fn()
    finally:
        argparse.ArgumentParser.parse_args = orig
        sys.argv = old_argv
    return {a.option_strings[0]: (a.default, a.type, a.choices, a.required)
            for a in seen["parser"]._actions if a.option_strings
            and a.option_strings[0] != "-h"}


def test_cli_flags_are_test_zs_flags_plus_device():
    from lseg_tpu_torch import test_zs

    need = ["--weights", "w", "--bpe_vocab", "v"]
    ref = _flags(_jax_test_zs().parse_args, need)
    got = _flags(lambda: test_zs.parse_args(need), [])
    assert set(got) == set(ref) | {"--device"}
    assert got["--device"][0] == "cuda"
    # the same defaults, but for the split files' place: the reference's
    # default is an absolute path of its own machine
    assert {k: v for k, v in got.items()
            if k not in ("--device", "--splits_dir")} == {
        k: v for k, v in ref.items() if k != "--splits_dir"}


# test_zs.py's tiny backbone: the tiny ViT with a text tower that reads
# the CLIP vocabulary's ids at CLIP's 77-token context, as `test_zs.py`
# tokenizes (it passes no context length)
TINY_ZS_TEXT = dataclasses.replace(TINY_TEXT, vocab_size=49408,
                                   context_length=77, layers=1)


@pytest.fixture(scope="module")
def zs_tree(tmp_path_factory):
    from lseg_tpu.testing import tiny_vit_config, write_reference_ckpt
    from lseg_tpu.testing import write_reference_vocab

    root = tmp_path_factory.mktemp("zs")
    datapath, splits = write_fss_tree(root, ["ant", "bee"])
    cfg = tiny_vit_config(features=256, text=TINY_ZS_TEXT)
    ckpt, vocab = str(root / "ref.ckpt"), str(root / "bpe.txt.gz")
    write_reference_ckpt(ckpt, cfg)
    write_reference_vocab(vocab)
    return datapath, splits, ckpt, vocab, cfg


@pytest.fixture
def zs_argv(zs_tree, monkeypatch):
    from lseg_tpu import config as jconfig
    from lseg_tpu_torch import config as tconfig
    from lseg_tpu_torch.testing import tiny_vit_config as t_tiny

    datapath, splits, ckpt, vocab, cfg = zs_tree
    monkeypatch.setitem(jconfig.BACKBONES, "tiny_vit", cfg)
    monkeypatch.setitem(tconfig.BACKBONES, "tiny_vit", t_tiny(
        features=256, text=dataclasses.replace(
            t_tiny().text, vocab_size=49408, context_length=77, layers=1)))
    return ["--dataset", "fss", "--datapath", datapath, "--splits_dir",
            splits, "--weights", ckpt, "--bpe_vocab", vocab, "--backbone",
            "tiny_vit", "--img_size", "64"]


def _metrics_of(line):
    m = re.fullmatch(r"dataset=fss fold=0 nshot=0 backbone=tiny_vit "
                     r"mIoU=([\d.]+) FB-IoU=([\d.]+)", line)
    assert m, line
    return float(m[1]), float(m[2])


def _run_both(argv, tmp_path, monkeypatch, tag):
    """(port's line, JAX's line) of one run of each command line."""
    from lseg_tpu_torch import test_zs

    lines = []
    for name in ("jax", "port"):
        logpath = str(tmp_path / f"{name}_{tag}")
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["test_zs.py", *argv,
                                              "--logpath", logpath])
            _jax_test_zs().main()
        else:
            test_zs.main(argv + ["--logpath", logpath, "--device", "cpu"])
        path = Path(logpath) / "log_fewshot-test_fss_fold0.txt"
        lines.append(path.read_text().splitlines()[-1])
    return lines[1], lines[0]


def test_cli_log_line_matches_jax(native_libs, zs_argv, tmp_path, capsys,
                                  monkeypatch):
    """Both command lines on an FSS-1000 tree of 20 query episodes and a
    reference checkpoint of the tiny config. Run in fp32 (each package's
    `LSegNet` held to fp32 for the run), the port prints and logs JAX's
    line. As shipped, in bf16, a label may flip where the pair's two
    logits sit within bf16 rounding of each other (0.25% of the pixels
    between the bf16 and fp32 runs of either package on these weights):
    each metric of the port's bf16 line may stray from JAX's by at most
    twice what JAX's bf16 line strays from its fp32 line, plus 0.05: 0.03
    for the rounding of the three printed values and 0.02 for the port's
    own flips (its bf16 line strays 0.04 and 0.06 from its fp32 line on
    these weights, JAX's 0.01 and 0.02)."""
    import lseg_tpu.models.lseg as jlseg
    import lseg_tpu_torch.models.lseg as tlseg

    bf16 = _run_both(zs_argv, tmp_path, monkeypatch, "bf16")
    jnet, tnet = jlseg.LSegNet, tlseg.LSegNet
    monkeypatch.setattr(jlseg, "LSegNet",
                        lambda cfg, dtype: jnet(cfg, dtype=jnp.float32))
    monkeypatch.setattr(tlseg, "LSegNet",
                        lambda cfg, dtype, device: tnet(cfg, torch.float32,
                                                        device))
    fp32 = _run_both(zs_argv, tmp_path, monkeypatch, "fp32")
    out = capsys.readouterr().out
    print(f"bf16 port {bf16[0]}\nbf16 jax  {bf16[1]}\nfp32 port "
          f"{fp32[0]}\nfp32 jax  {fp32[1]}")
    assert fp32[0] == fp32[1] and bf16[0] in out and fp32[0] in out
    got, ref = _metrics_of(bf16[0]), _metrics_of(bf16[1])
    ref32 = _metrics_of(fp32[1])
    for g, r, r32 in zip(got, ref, ref32):
        assert abs(g - r) <= 2 * abs(r - r32) + 0.05, (got, ref, ref32)


def test_cli_default_device_without_card_exits(zs_argv):
    from lseg_tpu_torch import test_zs

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(SystemExit, match="--device cpu"):
        test_zs.main(zs_argv)
