"""Train LSeg with the PyTorch/CUDA port: the flags and dataset choice of
the reference's `train.py`.

    python -m lseg_tpu_torch.train --dataset ade20k --data_path ./datasets \\
        --batch_size 8 --base_lr 0.004 --max_epochs 240 \\
        --backbone clip_vitl16_384 --text_features ade20k_150.npy

The model is `LSegNet(cfg, dtype, remat=True)` with fp32 master
parameters, flat flash attention (`--flash-attn`, on by default: kernels
B6 forward and B7 backward) where the backbone allows it, seeded random
weights, and the label embeddings from `--text_features` (a (K, out_c)
.npy) or, without one, fixed random embeddings (smoke mode).
`--dataset synthetic` trains the tiny test config on colored shapes.
Loading a reference checkpoint (`--ckpt`) or embedding the labels with
the text tower of one (`--bpe_vocab`) is not ported yet (ROADMAP A14)
and raises.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from lseg_tpu_torch import flat_flash_eligible, get_config, get_labels
from lseg_tpu_torch.data.loader import DataLoader
from lseg_tpu_torch.models.layers import random_init_
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.train.loop import FitConfig, fit
from lseg_tpu_torch.train.optim import make_optimizer
from lseg_tpu_torch.train.step import TrainState, enable_grads


def parse_args(argv=None):
    p = argparse.ArgumentParser("lseg_tpu_torch trainer")
    p.add_argument("--dataset", default="ade20k",
                   choices=["ade20k", "citys", "pascal_voc", "pascal_aug",
                            "pcontext", "coco", "synthetic"])
    p.add_argument("--data_path", default="datasets")
    p.add_argument("--label_dir", default=None)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--base_size", type=int, default=None)
    p.add_argument("--crop_size", type=int, default=None)
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--ignore_index", type=int, default=-1)
    p.add_argument("--base_lr", type=float, default=0.004)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--midasproto", action="store_true")
    p.add_argument("--max_epochs", type=int, default=240)
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--backbone", default="clip_vitl16_384")
    p.add_argument("--num_features", type=int, default=256)
    p.add_argument("--arch_option", type=int, default=0)
    p.add_argument("--block_depth", type=int, default=0)
    p.add_argument("--activation", default="lrelu")
    p.add_argument("--no-batchnorm", dest="no_batchnorm",
                   action="store_true")
    p.add_argument("--widehead", action="store_true")
    p.add_argument("--widehead_hr", action="store_true")
    p.add_argument("--no-scaleinv", dest="no_scaleinv", action="store_true")
    p.add_argument("--exp_name", default="lseg")
    p.add_argument("--dry-run", dest="dry_run", action="store_true")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--ckpt_root", default="checkpoints")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--bpe_vocab", default=None)
    p.add_argument("--text_features", default=None,
                   help="precomputed (K, C) .npy label embeddings")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--flash-attn", dest="flash_attn",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="train with flat flash attention (kernels B6 and "
                        "B7 on the card); needs head_dim 64 and even heads")
    return p.parse_args(argv)


def build_dataset(args):
    if args.dataset == "synthetic":
        from lseg_tpu.data.synthetic import SyntheticSegDataset

        train = SyntheticSegDataset(n=64, size=args.crop_size, num_classes=4)
        val = SyntheticSegDataset(n=16, size=args.crop_size, num_classes=4,
                                  seed=1)
        return train, val, [f"class{i}" for i in range(4)]
    if args.dataset == "citys":
        from lseg_tpu.data.cityscapes import CitySegmentation as DS
    elif args.dataset == "pascal_voc":
        from lseg_tpu.data.voc import VOCSegmentation as DS
    elif args.dataset == "pascal_aug":
        from lseg_tpu.data.voc import VOCAugSegmentation as DS
    elif args.dataset == "pcontext":
        from lseg_tpu.data.voc import PContextSegmentation as DS
    elif args.dataset == "coco":
        from lseg_tpu.data.coco import COCOSegmentation as DS
    else:
        from lseg_tpu.data.ade20k import ADE20KSegmentation as DS
    train = DS(args.data_path, "train", base_size=args.base_size,
               crop_size=args.crop_size, ignore_index=args.ignore_index)
    val = DS(args.data_path, "val", mode="val", base_size=args.base_size,
             crop_size=args.crop_size, ignore_index=args.ignore_index)
    label_set = "pascal_voc" if args.dataset == "coco" else args.dataset
    return train, val, get_labels(label_set, args.label_dir)


def get_text_features(args, cfg, labels, device) -> torch.Tensor:
    if args.text_features:
        return torch.from_numpy(np.load(args.text_features)).float().to(
            device)
    if args.ckpt and args.bpe_vocab:
        raise NotImplementedError(
            "embedding the labels with the text tower of a reference "
            "checkpoint is not ported yet (ROADMAP A14); pass "
            "--text_features")
    print("WARNING: no text tower provided; using fixed random label "
          "embeddings (smoke mode)")
    g = torch.Generator().manual_seed(0)
    return torch.randn(len(labels), cfg.out_c, generator=g).to(device)


class _Overfit:
    """--dry-run: train repeatedly on ONE batch (the reference's
    overfit_batches)."""

    def __init__(self, ds, batch_size):
        self.ds, self.batch_size = ds, batch_size

    def __len__(self):
        return self.batch_size

    def __getitem__(self, i):
        return self.ds[i % self.batch_size]


def main(argv=None):
    args = parse_args(argv)
    if args.base_size is None:
        args.base_size = 2048 if args.dataset == "citys" else 520
    if args.crop_size is None:
        args.crop_size = 768 if args.dataset == "citys" else 480
    if args.ckpt:
        raise NotImplementedError(
            "initialising from a reference .ckpt / .npz is not ported yet "
            "(ROADMAP A14)")
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")

    train_ds, val_ds, labels = build_dataset(args)
    if args.dry_run:
        train_ds, val_ds = _Overfit(train_ds, args.batch_size), None

    if args.dataset == "synthetic":
        from lseg_tpu.testing import tiny_vit_config

        cfg = tiny_vit_config()
    else:
        cfg = get_config(args.backbone, features=args.num_features,
                         arch_option=args.arch_option,
                         block_depth=args.block_depth,
                         activation=args.activation,
                         use_bn=not args.no_batchnorm)
    if args.flash_attn and cfg.vit is not None:
        if flat_flash_eligible(cfg.vit.embed_dim, cfg.vit.num_heads,
                               cfg.vit.tp_layout):
            cfg = dataclasses.replace(cfg, vit=dataclasses.replace(
                cfg.vit, attn_impl="flashflat"))
        else:
            print("--flash-attn: backbone not eligible (head_dim != 64 or "
                  "odd heads); keeping einsum attention")

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = LSegNet(cfg, dtype, device, remat=True,
                    param_dtype=torch.float32)
    random_init_(model, torch.Generator(device).manual_seed(0))
    enable_grads(model)
    text_features = get_text_features(args, cfg, labels, device)

    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    opt = make_optimizer(model, args.base_lr,
                         max_steps=steps_per_epoch * args.max_epochs,
                         batch_size=args.batch_size, momentum=args.momentum,
                         weight_decay=args.weight_decay,
                         midas_proto=args.midasproto)
    state = TrainState(model, opt)
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True,
                              num_workers=args.num_workers, device=device)
    val_loader = None
    if val_ds is not None:
        val_loader = DataLoader(val_ds, args.batch_size, shuffle=False,
                                num_workers=args.num_workers, device=device)
    fit_cfg = FitConfig(
        max_epochs=args.max_epochs if not args.dry_run else 10,
        ignore_index=args.ignore_index,
        accumulate=args.accumulate_grad_batches,
        ckpt_dir=f"{args.ckpt_root}/{args.exp_name}",
        resume=not args.no_resume)
    fit(state, train_loader, text_features, fit_cfg, val_loader,
        nclass=len(labels))


if __name__ == "__main__":
    main()
