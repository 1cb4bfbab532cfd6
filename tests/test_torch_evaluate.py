"""`python -m lseg_tpu_torch.evaluate` on the CPU: a two-image ADE20K
tree, a reference checkpoint of the tiny config (at the features width
256 that `get_config` gives every backbone) registered as a backbone, and
small base / crop sizes. The multi-scale log against the JAX package's
evaluator on the same weights and images; every branch runs; no silent
CPU."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lseg_tpu.data.ade20k import ADE20KSegmentation as JADE
from lseg_tpu.data.labels import get_labels as j_get_labels
from lseg_tpu.engine.serve import make_logits_fn as j_logits_fn
from lseg_tpu.engine.tta import MultiScaleEvaluator as JMulti
from lseg_tpu.engine.tta import TTAProtocol as JProto
from lseg_tpu.models.lseg import LSegNet as JNet
from lseg_tpu.ops.metrics import SegmentationMetric as JMetric
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
from lseg_tpu_torch import config as tconfig
from lseg_tpu_torch import evaluate
from lseg_tpu_torch.testing import tiny_vit_config as t_tiny

SCALES = ["0.5", "1.0", "1.5"]
# bf16 forwards of two packages: a label may flip where two summed logits
# sit within bf16 rounding of each other; the share of such pixels bounds
# the pixAcc difference (half a percent allowed), and one flip moves a
# class's IoU by at most a few hundredths at these sizes and the mean over
# the 150 classes by less.
PIXACC_TOL, MIOU_TOL, IOU_TOL = 0.005, 0.001, 0.05


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.RandomState(0)
    for split in ("training", "validation"):
        img_dir = root / "ADEChallengeData2016" / "images" / split
        ann_dir = root / "ADEChallengeData2016" / "annotations" / split
        img_dir.mkdir(parents=True)
        ann_dir.mkdir(parents=True)
        for i in range(2):
            arr = rng.randint(0, 255, (70, 90, 3), np.uint8)
            Image.fromarray(arr).save(img_dir / f"ADE_{split}_{i}.jpg")
            mask = rng.randint(0, 151, (70, 90)).astype(np.uint8)
            Image.fromarray(mask).save(ann_dir / f"ADE_{split}_{i}.png")
    cfg = tiny_vit_config(features=256)
    ckpt, vocab = str(root / "ref.ckpt"), str(root / "bpe.txt.gz")
    write_reference_ckpt(ckpt, cfg)
    write_reference_vocab(vocab)
    return root, ckpt, vocab, cfg


@pytest.fixture
def argv(tree, tmp_path, monkeypatch):
    root, ckpt, vocab, _ = tree
    monkeypatch.setitem(tconfig.BACKBONES, "tiny_vit", t_tiny())
    return ["--data_path", str(root), "--weights", ckpt, "--bpe_vocab",
            vocab, "--backbone", "tiny_vit", "--base_size", "72",
            "--crop_size", "64", "--device", "cpu", "--logdir",
            str(tmp_path / "logs")]


def _log(tmp_path, mode):
    text = (tmp_path / "logs" / f"log_test_ade20k_{mode}.txt").read_text()
    head = re.match(r"pixAcc: ([\d.]+), mIoU: ([\d.]+), images: (\d+)",
                    text)
    ious = [float(m) for m in re.findall(r"^ +\d+ .*: ([\d.]+)$", text,
                                         re.M)]
    return float(head[1]), float(head[2]), int(head[3]), np.array(ious)


def test_multiscale_log_matches_jax(tree, argv, tmp_path, capsys):
    root, ckpt, vocab, cfg = tree
    pa, miou, per_class = evaluate.main(argv + ["--scales", *SCALES])
    assert "FINAL pixAcc" in capsys.readouterr().out
    log_pa, log_miou, n, log_ious = _log(tmp_path, "multi")
    assert n == 2 and len(log_ious) == 150
    assert abs(log_pa - pa) <= 5e-5 and abs(log_miou - miou) <= 5e-5

    variables, text_vars = j_load(ckpt, cfg)
    tok = JTokenizer.from_file(vocab, cfg.text.context_length)
    labels = j_get_labels("ade20k")
    txt = JCache(cfg.text, text_vars, tok)(tuple(labels))
    ev = JMulti(j_logits_fn(JNet(cfg, dtype=jnp.bfloat16), variables), 150,
                JProto(base_size=72, crop_size=64,
                       scales=tuple(float(s) for s in SCALES)))
    metric = JMetric(150)
    ds = JADE(str(root), "val", mode="testval", base_size=72, crop_size=64)
    for i in range(len(ds)):
        logits = ev(ds[i]["image"], txt, return_logits=True)
        metric.update(jnp.asarray(logits)[None],
                      jnp.asarray(ds[i]["target"])[None])
    ref_pa, ref_miou = metric.get()
    print(f"pixAcc port {pa} jax {ref_pa}; mIoU port {miou} jax {ref_miou}")
    assert abs(pa - ref_pa) <= PIXACC_TOL
    assert abs(miou - ref_miou) <= MIOU_TOL
    assert np.max(np.abs(per_class - metric.per_class_iou())) <= IOU_TOL


@pytest.mark.parametrize("flags", [
    ["--no-tta"], ["--fast", "--int8", "--int8-cal", "2"], ["--acc-bn"]],
    ids=["no-tta", "fast-int8-cal", "acc-bn"])
def test_cli_branches_run(flags, argv, tmp_path, capsys):
    pa, miou, per_class = evaluate.main(argv + ["--scales", "1.0", *flags])
    out = capsys.readouterr().out
    assert "FINAL pixAcc" in out and 0.0 <= pa <= 1.0
    assert len(per_class) == 150
    if "--int8-cal" in flags:
        assert "calibrating int8 activation scales on 2 val images" in out
    if "--acc-bn" in flags:
        assert "precise BN" in out
    mode = "single" if "--no-tta" in flags else "multi"
    assert _log(tmp_path, mode)[2] == 2


def test_no_tta_sink_takes_the_metric_forwards(argv):
    """`--no-tta` with a sink: one flip-merged forward pair a batch gives
    both the metric update and the sink's labels."""
    from lseg_tpu_torch.engine.eval_single import SingleScaleEvaluator
    from lseg_tpu_torch.engine.serve import make_logits_fn

    args = evaluate.parse_args(argv + ["--no-tta"])
    model, txt, labels = evaluate.build(args)
    forwards = []
    model.register_forward_hook(lambda *_: forwards.append(1))
    preds = {}
    evaluate.run(args, model, txt, labels, sink=preds.__setitem__)
    ds = evaluate.make_dataset(args, "val", "val")
    assert len(forwards) == 2 and len(ds) == 2 < args.batch_size
    # the batch as run pads it: the last image repeated up to batch_size
    batch = [ds[0]] + [ds[1]] * (args.batch_size - 1)
    imgs = evaluate._stack(batch, "image", txt.device)
    want = SingleScaleEvaluator(make_logits_fn(model), 150, flip=True)(
        imgs, txt)[:2]
    assert list(preds) == [0] and preds[0].dtype == torch.int32
    assert torch.equal(preds[0], want)


def test_cli_export_reads_back_in_jax(tree, argv, tmp_path):
    _, ckpt, _, cfg = tree
    path = str(tmp_path / "w.npz")
    assert evaluate.main(argv + ["--export", path]) is None
    got = jckpt.import_params(path)
    want, _ = j_load(ckpt, cfg)
    # the bf16 model's weights: the checkpoint's rounded to bf16
    w = want["params"]["head1"]["kernel"]
    np.testing.assert_array_equal(
        got["params"]["head1"]["kernel"],
        torch.from_numpy(w).bfloat16().float().numpy())
    assert set(got) == {"params", "batch_stats"}


def test_default_device_without_card_exits(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    i = argv.index("--device")
    with pytest.raises(SystemExit, match="--device cpu"):
        evaluate.main(argv[:i] + argv[i + 2:])
