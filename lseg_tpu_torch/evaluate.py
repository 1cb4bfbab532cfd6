"""Evaluate LSeg with the PyTorch/CUDA port: the flags, dataset defaults
and outputs of the reference's `evaluate.py` (test_lseg.py / test.sh),
plus `--device`.

    python -m lseg_tpu_torch.evaluate --dataset ade20k --data_path datasets \\
        --weights ckpt.ckpt --bpe_vocab bpe.gz [--no-tta] [--limit N]

The weights come from a reference checkpoint (`utils.checkpoint_convert`)
and the label embeddings from its text tower with the `--bpe_vocab`
vocabulary. Multi-scale sliding-window + flip TTA (`engine.tta`, the
6-scale protocol) or, with `--no-tta`, the single-scale center-crop
protocol (`engine.eval_single`) over the val split; pixAcc, mIoU and the
per-class IoU go to `<logdir>/log_test_<dataset>_<single|multi>.txt` and a
`FINAL pixAcc ... mIoU ...` line to stdout. `--device` defaults to
`cuda`; without a card the command exits unless it is given
`--device cpu`.

`build(args)` makes the model and the text features, and `run(args,
model, text_features, labels, dataset)` evaluates them on any dataset
object whose items are {'image': (H, W, 3) fp32, 'target': (H, W) int}.
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser("lseg_tpu_torch evaluator")
    p.add_argument("--dataset", default="ade20k",
                   choices=["ade20k", "citys", "pascal_voc",
                            "pascal_aug", "pcontext", "coco"])
    p.add_argument("--data_path", default="datasets")
    p.add_argument("--label_dir", default=None,
                   help="reference-format label_files dir (default: "
                        "packaged lists)")
    p.add_argument("--weights", required=True)
    p.add_argument("--bpe_vocab", required=True)
    p.add_argument("--backbone", default="clip_vitl16_384")
    p.add_argument("--base_size", type=int, default=None)
    p.add_argument("--crop_size", type=int, default=None)
    p.add_argument("--scales", type=float, nargs="+", default=None)
    p.add_argument("--no-tta", dest="no_tta", action="store_true",
                   help="single-scale center-crop protocol instead")
    p.add_argument("--no-flip", dest="no_flip", action="store_true")
    p.add_argument("--batch_size", type=int, default=8,
                   help="single-scale batch")
    p.add_argument("--limit", type=int, default=0,
                   help="evaluate only the first N images (0 = all)")
    p.add_argument("--logdir", default="logs")
    p.add_argument("--acc-bn", dest="acc_bn", action="store_true",
                   help="re-estimate BN running stats on train data "
                        "before eval (precise BN)")
    p.add_argument("--acc_bn_batches", type=int, default=100)
    p.add_argument("--export", default=None,
                   help="write the loaded weights as a raw .npz (the JAX "
                        "package's layout) and exit")
    p.add_argument("--fast", action="store_true",
                   help="fast serving config (config.fast_serving); the "
                        "default is the parity config")
    p.add_argument("--int8-cal", dest="int8_cal", type=int, default=0,
                   metavar="N",
                   help="with --fast --int8: calibrate static activation "
                        "scales on N val images (0 = dynamic scales)")
    p.add_argument("--int8", action="store_true",
                   help="with --fast: static int8 projections and decoder "
                        "convs")
    p.add_argument("--arch_option", type=int, default=0)
    p.add_argument("--block_depth", type=int, default=0)
    p.add_argument("--activation", default="lrelu")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default cuda; pass "
                        "--device cpu to evaluate on the CPU)")
    args = p.parse_args(argv)
    base_d, crop_d, scales_d = _DATASET_DEFAULTS[args.dataset]
    if args.base_size is None:
        args.base_size = base_d
    if args.crop_size is None:
        args.crop_size = crop_d
    if args.scales is None:
        args.scales = list(scales_d)
    return args


_STD_SCALES = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)
_DATASET_DEFAULTS = {
    # name -> (base_size, crop_size, scales)
    "ade20k": (520, 480, _STD_SCALES),
    "citys": (2048, 768, (0.75, 1.0, 1.25, 1.5, 1.75, 2.0, 2.25)),
    "pascal_voc": (520, 480, _STD_SCALES),
    "pascal_aug": (520, 480, _STD_SCALES),
    "pcontext": (520, 480, _STD_SCALES),
    "coco": (520, 480, _STD_SCALES),
}


def make_dataset(args, split: str, mode: str):
    if args.dataset == "citys":
        from lseg_tpu_torch.data.cityscapes import CitySegmentation as DS
    elif args.dataset == "pascal_voc":
        from lseg_tpu_torch.data.voc import VOCSegmentation as DS
    elif args.dataset == "pascal_aug":
        from lseg_tpu_torch.data.voc import VOCAugSegmentation as DS
    elif args.dataset == "pcontext":
        from lseg_tpu_torch.data.voc import PContextSegmentation as DS
    elif args.dataset == "coco":
        from lseg_tpu_torch.data.coco import COCOSegmentation as DS
    else:
        from lseg_tpu_torch.data.ade20k import ADE20KSegmentation as DS
    return DS(args.data_path, split, mode=mode, base_size=args.base_size,
              crop_size=args.crop_size)


def build(args):
    """(model, text_features, labels) from `args`: the config, the
    reference checkpoint (quantized with `--int8`), the label set and its
    text features on `args.device`."""
    from lseg_tpu_torch import fast_serving, get_config, get_labels
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.ops.quant import quantize_tree
    from lseg_tpu_torch.text.cache import TextFeatureCache
    from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer
    from lseg_tpu_torch.utils.checkpoint_convert import (
        load_reference_checkpoint,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA card is available; pass "
            f"--device cpu to evaluate on the CPU")
    if args.int8_cal and not args.int8:
        raise SystemExit("--int8-cal requires --fast --int8")
    if args.int8 and not args.fast:
        raise SystemExit("--int8 requires --fast")
    cfg = get_config(args.backbone, arch_option=args.arch_option,
                     block_depth=args.block_depth,
                     activation=args.activation)
    if args.fast:
        quant = False
        if args.int8:
            quant = "static_cal" if args.int8_cal else "static"
        cfg = fast_serving(cfg, quant=quant)
    state, text_state = load_reference_checkpoint(args.weights, cfg)
    if args.int8:
        # quantized on the model's device: the card and the CPU can round
        # a weight scale apart in its last bit
        state = {k: v.to(device) for k, v in state.items()}
        cal = bool(args.int8_cal)
        state = quantize_tree(state, decoder=True, act_scale=cal,
                              mlp_act_scale=cal and cfg.vit is not None
                              and cfg.vit.mlp_act_cal)
    model = LSegNet(cfg, torch.bfloat16, device)
    model.load_state_dict(state)
    del state
    # the 'coco' seg dataset paints the 21 VOC classes
    label_set = "pascal_voc" if args.dataset == "coco" else args.dataset
    labels = get_labels(label_set, args.label_dir)
    tok = ClipBPETokenizer.from_file(args.bpe_vocab, cfg.text.context_length)
    txt = TextFeatureCache(cfg.text, text_state, tok,
                           device=device)(tuple(labels))
    return model, txt, labels


def _stack(items, key, device) -> torch.Tensor:
    return torch.stack([torch.as_tensor(b[key]) for b in items]).to(device)


def run(args, model, text_features, labels, dataset=None, cal_dataset=None,
        sink=None):
    """Calibrate (`--int8-cal`), export (`--export`: returns None),
    re-estimate BN (`--acc-bn`), then evaluate `dataset` (default: the val
    split in the protocol's mode) and write the log. `cal_dataset`
    defaults to the val split center-cropped; precise BN reads the train
    split. `sink(i, labels)`, if given, takes each image's label map (or
    each batch's, with `--no-tta`). Returns (pixAcc, mIoU, per-class
    IoU)."""
    from lseg_tpu_torch.engine.eval_single import SingleScaleEvaluator
    from lseg_tpu_torch.engine.serve import make_logits_fn
    from lseg_tpu_torch.engine.tta import MultiScaleEvaluator, TTAProtocol
    from lseg_tpu_torch.ops.metrics import SegmentationMetric

    device = text_features.device
    if args.int8_cal:
        from lseg_tpu_torch.ops.quant import calibrate_act_scales

        if cal_dataset is None:
            cal_dataset = make_dataset(args, "val", "val")
        m = min(args.int8_cal, len(cal_dataset))
        print(f"calibrating int8 activation scales on {m} val images")
        calibrate_act_scales(
            model, _stack([cal_dataset[j] for j in range(m)], "image",
                          device), None)
    if args.export:
        from lseg_tpu_torch.train.checkpoint import export_params

        export_params(args.export, model)
        print(f"exported {args.export}")
        return None
    if args.acc_bn:
        from lseg_tpu_torch.utils.precise_bn import update_bn_stats

        train = make_dataset(args, "train", "train")
        bs, n = args.batch_size, len(train)
        batches = (_stack([train[j] for j in range(i, min(i + bs, n))],
                          "image", device) for i in range(0, n, bs))
        print("re-estimating BN statistics (precise BN)")
        update_bn_stats(model, batches, max_batches=args.acc_bn_batches)

    metric = SegmentationMetric(len(labels), ignore_index=-1)
    logits_fn = make_logits_fn(model)
    t0 = time.time()
    if args.no_tta:
        ds = dataset if dataset is not None else make_dataset(
            args, "val", "val")
        ev = SingleScaleEvaluator(logits_fn, len(labels),
                                  flip=not args.no_flip)
        n = min(len(ds), args.limit) if args.limit else len(ds)
        bs = args.batch_size
        # tail batch: pad by repeating the last image; the pad rows get an
        # all-ignore target, so they weigh nothing in the metric
        for i in range(0, n, bs):
            idx = list(range(i, min(i + bs, n)))
            pad = bs - len(idx)
            batch = [ds[j] for j in idx] + [ds[idx[-1]]] * pad
            imgs = _stack(batch, "image", device)
            tgts = _stack(batch, "target", device)
            if pad:
                tgts[len(idx):] = -1
            logits = ev.logits(imgs, text_features)
            metric.update(logits, tgts)
            if sink is not None:
                sink(i, torch.argmax(logits[:len(idx)], dim=-1).to(
                    torch.int32))
            if (i // bs) % 10 == 0:
                pa, miou = metric.get()
                print(f"[{i + bs}/{n}] pixAcc {pa:.4f} mIoU {miou:.4f}",
                      flush=True)
    else:
        ds = dataset if dataset is not None else make_dataset(
            args, "val", "testval")
        proto = TTAProtocol(base_size=args.base_size,
                            crop_size=args.crop_size,
                            scales=tuple(args.scales),
                            flip=not args.no_flip)
        ev = MultiScaleEvaluator(logits_fn, len(labels), proto)
        n = min(len(ds), args.limit) if args.limit else len(ds)
        for i in range(n):
            sample = ds[i]
            logits = ev(sample["image"], text_features, return_logits=True)
            metric.update(logits[None], torch.as_tensor(
                sample["target"], device=device)[None])
            if sink is not None:
                sink(i, torch.argmax(logits, dim=-1).to(torch.int32))
            if i % 10 == 0:
                pa, miou = metric.get()
                print(f"[{i + 1}/{n}] pixAcc {pa:.4f} mIoU {miou:.4f}",
                      flush=True)

    pix_acc, miou = metric.get()
    per_class = metric.per_class_iou()
    dt = time.time() - t0
    os.makedirs(args.logdir, exist_ok=True)
    mode = "single" if args.no_tta else "multi"
    with open(os.path.join(args.logdir,
                           f"log_test_{args.dataset}_{mode}.txt"), "a") as f:
        f.write(f"pixAcc: {pix_acc:.4f}, mIoU: {miou:.4f}, "
                f"images: {n}, seconds: {dt:.1f}\n")
        for i, iou in enumerate(per_class):
            f.write(f"  {i:3d} {labels[i]}: {iou:.4f}\n")
    print(f"FINAL pixAcc {pix_acc:.4f} mIoU {miou:.4f} ({dt:.1f}s)")
    return pix_acc, miou, per_class


def main(argv=None):
    args = parse_args(argv)
    model, txt, labels = build(args)
    return run(args, model, txt, labels)


if __name__ == "__main__":
    main()
