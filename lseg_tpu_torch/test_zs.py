"""Zero-shot / few-shot transfer evaluation with the PyTorch/CUDA port:
the flags and outputs of the reference's `test_zs.py` (test_lseg_zs.py),
plus `--device`. The 1000-episode protocol on PASCAL-5i, COCO-20i or
FSS-1000 with the binary ['others', <class>] head, reporting mIoU and
FB-IoU.

    python -m lseg_tpu_torch.test_zs --dataset pascal --fold 0 \\
        --datapath datasets --splits_dir fewshot_data/data/splits \\
        --weights ckpt.ckpt --bpe_vocab bpe_simple_vocab_16e6.txt.gz \\
        --backbone clip_resnet101

The weights come from a reference checkpoint (`utils.checkpoint_convert`)
into `LSegNet` in bf16 on `get_config(--backbone, ...)`; the pair
embeddings from its text tower with the `--bpe_vocab` vocabulary. ResNet
backbones read ImageNet-normalised images. The result line goes to stdout
and is appended to `<logpath>/log_fewshot-test_<dataset>_fold<k>.txt`.
`--device` defaults to `cuda`; without a card the command exits unless
it is given `--device cpu`.
"""

from __future__ import annotations

import argparse
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser("lseg_tpu_torch zero-shot eval")
    p.add_argument("--dataset", default="pascal",
                   choices=["pascal", "coco", "fss"])
    p.add_argument("--datapath", default="datasets")
    p.add_argument("--splits_dir", default="fewshot_data/data/splits",
                   help="the reference's split files (fewshot_data/data/"
                        "splits of its repository)")
    p.add_argument("--label_dir", default=None,
                   help="reference-format label_files dir (default: packaged lists)")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--nshot", type=int, default=0)
    p.add_argument("--backbone", default="clip_resnet101")
    p.add_argument("--weights", required=True)
    p.add_argument("--bpe_vocab", required=True)
    p.add_argument("--img_size", type=int, default=480)
    p.add_argument("--bsz", type=int, default=8)
    p.add_argument("--arch_option", type=int, default=0)
    p.add_argument("--block_depth", type=int, default=0)
    p.add_argument("--activation", default="lrelu")
    p.add_argument("--logpath", default="logs/fewshot")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--visualize", action="store_true",
                   help="save support/pred/gt composites per episode "
                        "to --vis_path (reference "
                        "fewshot_data/common/vis.py)")
    p.add_argument("--vis_path", default="vis")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default cuda; pass "
                        "--device cpu to evaluate on the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA card is available; pass "
            f"--device cpu to evaluate on the CPU")
    from lseg_tpu_torch import get_config, get_labels
    from lseg_tpu_torch.data.fewshot import build_fewshot_dataset
    from lseg_tpu_torch.engine.episodic import (
        EpisodicEvaluator,
        make_episodic_predictor,
    )
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.text.cache import TextFeatureCache
    from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer
    from lseg_tpu_torch.utils.checkpoint_convert import (
        load_reference_checkpoint,
    )

    cfg = get_config(args.backbone, arch_option=args.arch_option,
                     block_depth=args.block_depth,
                     activation=args.activation)
    state, text_state = load_reference_checkpoint(args.weights, cfg)
    model = LSegNet(cfg, torch.bfloat16, device)
    model.load_state_dict(state)
    del state

    labels = get_labels(args.dataset, args.label_dir)
    tok = ClipBPETokenizer.from_file(args.bpe_vocab)
    cache = TextFeatureCache(cfg.text, text_state, tok, device=device)

    # RN101 uses ImageNet norm (reference: dataset.py:19-26,
    # test_lseg_zs.py:266-270)
    imagenet_norm = "resnet" in args.backbone
    ds = build_fewshot_dataset(
        args.dataset, args.datapath, args.fold, "test", args.nshot,
        splits_dir=args.splits_dir, img_size=args.img_size,
        imagenet_norm=imagenet_norm, seed=args.seed,
    )

    def pair_features(class_id: int):
        return cache.pair_features(labels[class_id])

    predictor = make_episodic_predictor(model)
    vis = None
    if args.visualize:
        from lseg_tpu_torch.utils.fewshot_vis import EpisodeVisualizer

        stats = (((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
                 if imagenet_norm else ((0.5,) * 3, (0.5,) * 3))
        vis = EpisodeVisualizer(args.vis_path, mean=stats[0],
                                std=stats[1])
    evaluator = EpisodicEvaluator(predictor, ds.class_ids, visualizer=vis)
    miou, fb_iou = evaluator.run(ds, pair_features, batch_size=args.bsz)

    os.makedirs(args.logpath, exist_ok=True)
    line = (f"dataset={args.dataset} fold={args.fold} nshot={args.nshot} "
            f"backbone={args.backbone} mIoU={miou:.2f} FB-IoU={fb_iou:.2f}")
    print(line)
    with open(os.path.join(
        args.logpath,
        f"log_fewshot-test_{args.dataset}_fold{args.fold}.txt",
    ), "a") as f:
        f.write(line + "\n")
    return miou, fb_iou


if __name__ == "__main__":
    main()
