"""Open-vocabulary segmentation demo with the PyTorch/CUDA port: the flags
and outputs of `demo.py` (the reference's lseg_demo.ipynb as a command),
plus `--device`. Segments an image against a free-text label list and
saves an overlay with a legend.

    python -m lseg_tpu_torch.demo --image cat1.jpeg \\
        --labels "plant,grass,cat,stone,other" --weights demo_e200.ckpt \\
        --bpe_vocab bpe_simple_vocab_16e6.txt.gz [--tta] [--fast [--int8]]

`--weights random` is a smoke run: seeded random weights and label
embeddings, no text tower. Without `--tta` the single-scale predictor
(`engine.serve.make_predictor`) runs at the app's 480x360 shape, padded
to 480x384 (the decoder takes multiples of 32) and cropped back; with
`--tta`, the multi-scale + flip protocol (`engine.tta.
MultiScaleEvaluator`) at the image's own size. `--fast` takes
`fast_serving(cfg)` (the kernels of the fast path), `--fast --int8`
`fast_serving(cfg, quant='static')` on a `quantize_tree(decoder=True)`
state. `--device` defaults to `cuda`; without a card the command exits
unless it is given `--device cpu`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from PIL import Image

# the app's Resize([360, 480]), padded to a multiple of 32 and back
APP_H, APP_W, APP_PAD = 360, 480, 12


def parse_args(argv=None):
    p = argparse.ArgumentParser("lseg_tpu demo")
    p.add_argument("--image", required=True)
    p.add_argument("--labels", required=True,
                   help="comma-separated label list")
    p.add_argument("--weights", required=True,
                   help="reference .ckpt, or 'random' for a smoke run "
                        "with random weights (no text tower)")
    p.add_argument("--bpe_vocab", default=None,
                   help="CLIP BPE vocab (required unless --weights random)")
    p.add_argument("--backbone", default="clip_vitl16_384")
    p.add_argument("--out", default="demo_out.png")
    p.add_argument("--tta", action="store_true")
    p.add_argument("--fast", action="store_true",
                   help="fast serving config (flash kernels + tanh "
                        "GELU + bf16 head; lseg_tpu_torch.config."
                        "fast_serving)")
    p.add_argument("--int8", action="store_true",
                   help="with --fast: static int8 projections + "
                        "decoder convs")
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; pass "
                        "--device cpu to run on the CPU)")
    return p.parse_args(argv)


def split_labels(label_str: str):
    return [s.strip() for s in label_str.split(",") if s.strip()]


def build(args, labels):
    """(model, text_features) of `args`: the bf16 `LSegNet` of
    `--backbone` (fast and int8 as asked) on `--device`, and the (K, C)
    label embeddings."""
    from lseg_tpu_torch import fast_serving, get_config
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.ops.quant import quantize_tree

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA card is available; pass "
            f"--device cpu to run on the CPU")
    base = get_config(args.backbone)
    cfg = base
    if args.fast:
        cfg = fast_serving(cfg, quant="static" if args.int8 else False)
    elif args.int8:
        raise SystemExit("--int8 requires --fast")
    if args.weights == "random":
        print("SMOKE MODE: random weights + random label embeddings")
        g = torch.Generator(device=device).manual_seed(0)
        state = random_init_(LSegNet(base, torch.float32, device),
                             g).state_dict()
        txt = torch.randn((len(labels), cfg.out_c), generator=g.manual_seed(1),
                          device=device)
    else:
        from lseg_tpu_torch.text.cache import TextFeatureCache
        from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer
        from lseg_tpu_torch.utils.checkpoint_convert import (
            load_reference_checkpoint,
        )

        if not args.bpe_vocab:
            raise SystemExit("--bpe_vocab is required unless --weights "
                             "random")
        state, text_state = load_reference_checkpoint(args.weights, cfg)
        tok = ClipBPETokenizer.from_file(args.bpe_vocab,
                                         cfg.text.context_length)
        txt = TextFeatureCache(cfg.text, text_state, tok,
                               device=device)(tuple(labels))
    if args.int8:
        # quantized on the model's device, as `evaluate` does
        state = quantize_tree({k: v.to(device) for k, v in state.items()},
                              decoder=True)
    model = LSegNet(cfg, torch.bfloat16, device)
    model.load_state_dict(state)
    return model, txt


def segment(predictor, logits_fn, txt, pil: Image.Image, tta: bool):
    """(labels (H, W) int numpy, the uint8 image they label): the TTA
    protocol at the image's own size through `logits_fn`, or `predictor`
    at the app shape."""
    from lseg_tpu_torch.data.transforms import normalize
    from lseg_tpu_torch.engine.tta import MultiScaleEvaluator

    if tta:
        img = normalize(np.asarray(pil, np.uint8)).astype(np.float32)
        ev = MultiScaleEvaluator(logits_fn, num_classes=txt.shape[0])
        return ev(img, txt).cpu().numpy(), np.asarray(pil, np.uint8)
    small = pil.resize((APP_W, APP_H), Image.BILINEAR)
    img = normalize(np.asarray(small, np.uint8)).astype(np.float32)
    x = np.pad(img, ((APP_PAD, APP_PAD), (0, 0), (0, 0)),
               constant_values=-1.0)
    pred = predictor(x[None], txt)[0][APP_PAD:-APP_PAD]
    return pred.cpu().numpy(), np.asarray(small, np.uint8)


def main(argv=None):
    args = parse_args(argv)
    from lseg_tpu_torch.engine.serve import make_logits_fn, make_predictor
    from lseg_tpu_torch.utils.palette import (
        class_palette,
        legend_patches,
        overlay,
    )

    labels = split_labels(args.labels)
    model, txt = build(args, labels)
    pil = Image.open(args.image).convert("RGB")
    pred, shown = segment(make_predictor(model), make_logits_fn(model), txt,
                          pil, args.tta)
    pal = class_palette(len(labels))
    Image.fromarray(overlay(shown, pred, pal, alpha=args.alpha)).save(
        args.out)
    print(f"saved {args.out}")
    for name, color in legend_patches(pred, labels, pal):
        print(f"  {name}: rgb{color}")
    return pred


if __name__ == "__main__":
    main()
