"""HSNet few-shot baseline with the PyTorch/CUDA port: the train and test
driver of the reference's fewshot_data/train.py + test.py, with the flags
and outputs of `hsnet_run.py`, plus `--device`. Adam 1e-3 on the HPN
learner with the torchvision backbone frozen, a cross-entropy objective,
mIoU and FB-IoU from the episode meter.

    python -m lseg_tpu_torch.hsnet_run test --dataset pascal --fold 0 \\
        --nshot 1 --datapath datasets --splits_dir .../splits \\
        --backbone_weights resnet101.pth
    python -m lseg_tpu_torch.hsnet_run train --dataset pascal --fold 0 ...

The model is `models.hsnet.HSNet` on ResNet(`--layers`) in bf16, its
backbone from a torchvision `state_dict` (`--backbone_weights`, through
`models.hsnet.load_backbone`) or, without one, seeded random weights.
`--device` defaults to `cuda`; without a card the command exits unless
it is given `--device cpu`. Threads decode the next batch's episodes
while the current one runs.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# threads that decode the next batch's episodes
DECODE_THREADS = min(8, os.cpu_count() or 1)


def parse_args(argv=None):
    p = argparse.ArgumentParser("hsnet")
    p.add_argument("mode", choices=["train", "test"])
    p.add_argument("--dataset", default="pascal",
                   choices=["pascal", "coco", "fss"])
    p.add_argument("--datapath", default="datasets")
    p.add_argument("--splits_dir", default="fewshot_data/data/splits",
                   help="the reference's split files (fewshot_data/data/"
                        "splits of its repository)")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--nshot", type=int, default=1)
    p.add_argument("--bsz", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--niter", type=int, default=2000)
    p.add_argument("--img_size", type=int, default=400)
    p.add_argument("--backbone_weights", default=None,
                   help="torchvision resnet101 .pth")
    p.add_argument("--layers", type=int, nargs=4, default=[3, 4, 23, 3])
    p.add_argument("--visualize", action="store_true",
                   help="save support/pred/gt composites per episode "
                        "(reference fewshot_data/common/vis.py)")
    p.add_argument("--vis_path", default="vis")
    p.add_argument("--use_original_imgsize", action="store_true",
                   help="evaluate at each episode's original query size "
                        "(reference test.py:63, hsnet.py:55-75); "
                        "forces bsz=1 (per-episode mask shapes)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; pass "
                        "--device cpu to run on the CPU)")
    args = p.parse_args(argv)
    if args.use_original_imgsize:
        args.bsz = 1
    return args


def device_of(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA card is available; pass "
            f"--device cpu to run on the CPU")
    return device


def build(args, param_dtype=None):
    """The bf16 `HSNet` of `args` on its device, seeded (seed 0), its
    backbone from `--backbone_weights` where given.
    `param_dtype=torch.float32` keeps fp32 masters for training."""
    from lseg_tpu_torch.config import ResNetConfig
    from lseg_tpu_torch.models.hsnet import HSNet, load_backbone
    from lseg_tpu_torch.models.layers import random_init_

    device = device_of(args)
    model = HSNet(ResNetConfig(layers=tuple(args.layers)),
                  dtype=torch.bfloat16, device=device,
                  use_original_imgsize=getattr(args, "use_original_imgsize",
                                               False),
                  param_dtype=param_dtype)
    random_init_(model, torch.Generator(device=device).manual_seed(0))
    if args.backbone_weights:
        load_backbone(model, args.backbone_weights)
    return model


def episodes(args, split):
    from lseg_tpu_torch.data.fewshot import build_fewshot_dataset

    return build_fewshot_dataset(
        args.dataset, args.datapath, args.fold, split,
        max(args.nshot, 1), splits_dir=args.splits_dir,
        img_size=args.img_size, imagenet_norm=True,
        use_original_imgsize=getattr(args, "use_original_imgsize", False),
    )


def batches(ds, index_lists, device):
    """(batch, class ids) for each list of episode indices of `ds` in
    turn: the episodes stacked as tensors on `device`. A pool of threads
    decodes each list's episodes while the caller runs the batch before
    it (an episode is a function of its index alone)."""
    def stacked(futures):
        eps = [f.result() for f in futures]
        return {
            k: torch.from_numpy(np.stack([e[k] for e in eps])).to(device)
            for k in ("query_img", "query_mask", "query_ignore",
                      "support_imgs", "support_masks")
        }, np.asarray([e["class_id"] for e in eps])

    with ThreadPoolExecutor(DECODE_THREADS) as pool:
        pending = None
        for idxs in index_lists:
            ahead = [pool.submit(ds.__getitem__, int(i)) for i in idxs]
            if pending is not None:
                yield stacked(pending)
            pending = ahead
        if pending is not None:
            yield stacked(pending)


def test(args, model, ds):
    """The test protocol: every episode once in batches of `--bsz`;
    returns (mIoU, FB-IoU)."""
    from lseg_tpu_torch.models.hsnet import predict_mask_nshot
    from lseg_tpu_torch.ops.metrics import AverageMeter, episode_inter_union

    device = next(model.parameters()).device
    vis = None
    if args.visualize and args.use_original_imgsize:
        raise SystemExit(
            "--visualize needs network-size masks; drop "
            "--use_original_imgsize (the reference Visualizer has "
            "the same constraint)")
    if args.visualize:
        from lseg_tpu_torch.utils.fewshot_vis import EpisodeVisualizer

        vis = EpisodeVisualizer(
            args.vis_path,
            mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
        )
    meter = AverageMeter(ds.class_ids)
    n = len(ds)
    starts = range(0, n, args.bsz)
    with torch.inference_mode():
        for start, (batch, cids) in zip(starts, batches(
                ds, (range(s, min(s + args.bsz, n)) for s in starts),
                device)):
            org = (tuple(batch["query_mask"].shape[1:3])
                   if args.use_original_imgsize else None)
            pred = predict_mask_nshot(model, batch, args.nshot,
                                      org_size=org)
            inter, union = episode_inter_union(
                pred, batch["query_mask"], batch["query_ignore"])
            it, un = inter.cpu().numpy(), union.cpu().numpy()
            meter.update(it, un, cids)
            if vis is not None:
                vis.batch({k: v.cpu().numpy() for k, v in batch.items()},
                          pred.cpu().numpy(), list(cids),
                          start // args.bsz,
                          ious=it[:, 1] / np.maximum(un[:, 1], 1e-7))
            if (start // args.bsz) % 20 == 0:
                miou, fb = meter.compute_iou()
                print(f"[{start + len(cids)}/{n}] mIoU {miou:.2f} "
                      f"FB-IoU {fb:.2f}", flush=True)
    return meter.compute_iou()


def make_optimizer(model, lr: float) -> torch.optim.Optimizer:
    """Adam on the learner only (optax.adam's defaults); the backbone
    gets no gradient and no update."""
    from lseg_tpu_torch.train.step import enable_grads

    enable_grads(model.hpn_learner)
    return torch.optim.Adam(model.hpn_learner.parameters(), lr=lr,
                            betas=(0.9, 0.999), eps=1e-8)


def train_step(model, opt, batch) -> torch.Tensor:
    """One Adam step on the first shot's cross-entropy; returns the
    loss."""
    from lseg_tpu_torch.ops.losses import cross_entropy

    model.train()
    opt.zero_grad(set_to_none=True)
    logits = model(batch["query_img"], batch["support_imgs"][:, 0],
                   batch["support_masks"][:, 0])
    loss = cross_entropy(logits, batch["query_mask"])
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv=None):
    args = parse_args(argv)
    device_of(args)
    if args.mode == "test":
        model = build(args)
        ds = episodes(args, "test")
        miou, fb = test(args, model, ds)
        print(f"FINAL {args.dataset} fold{args.fold} {args.nshot}-shot "
              f"mIoU {miou:.2f} FB-IoU {fb:.2f}")
        return miou, fb

    # train: Adam on the learner, the backbone frozen (hsnet.py:104-106 +
    # train.py:23-24 of the reference)
    model = build(args, param_dtype=torch.float32)
    ds = episodes(args, "trn")
    opt = make_optimizer(model, args.lr)
    device = next(model.parameters()).device
    rng = np.random.RandomState(0)
    draws = (rng.randint(0, len(ds), args.bsz) for _ in range(args.niter))
    for it, (batch, _) in enumerate(batches(ds, draws, device)):
        loss = train_step(model, opt, batch)
        if it % 50 == 0:
            print(f"iter {it} loss {float(loss):.4f}", flush=True)
    return model


if __name__ == "__main__":
    main()
