"""Golden-parity harness against lang-seg's own logits, with the
PyTorch/CUDA port: the flags, report and PASS rule of `parity_check.py`,
plus `--device`.

1. On the reference side, dump the demo logits and the exact normalised
   input:
       out = lseg_model.net(image_tensor)           # (1, K, H, W)
       np.save("ref_logits.npy", out.cpu().numpy())
       np.save("ref_input.npy", image_tensor.cpu().numpy())

2. Here:
       python -m lseg_tpu_torch.parity_check --weights demo_e200.ckpt \\
           --bpe_vocab bpe_simple_vocab_16e6.txt.gz \\
           --ref_input ref_input.npy --ref_logits ref_logits.npy \\
           --labels "plant,grass,cat,stone,other"

Reports the max / mean absolute logit difference and the argmax
agreement. The model runs in fp32 (TF32 off) with the fp16-emulated
correlation of lang-seg's head (`LSegNet(..., emulate_fp16=True)`) for
the closest numerics. `--device` defaults to `cuda`; without a card the
command exits unless it is given `--device cpu`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

MAX_ABS_DIFF = 5e-2
MIN_AGREEMENT = 0.999


def parse_args(argv=None):
    p = argparse.ArgumentParser("lseg_tpu parity check")
    p.add_argument("--weights", required=True)
    p.add_argument("--bpe_vocab", required=True)
    p.add_argument("--ref_input", required=True,
                   help="(1,3,H,W) or (1,H,W,3) normalized fp32 .npy")
    p.add_argument("--ref_logits", required=True,
                   help="(1,K,H,W) reference logits .npy")
    p.add_argument("--labels", required=True)
    p.add_argument("--backbone", default="clip_vitl16_384")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; pass "
                        "--device cpu to run on the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA card is available; pass "
            f"--device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from lseg_tpu_torch import get_config
    from lseg_tpu_torch.demo import split_labels
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.text.cache import TextFeatureCache
    from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer
    from lseg_tpu_torch.utils.checkpoint_convert import (
        load_reference_checkpoint,
    )

    labels = split_labels(args.labels)
    cfg = get_config(args.backbone)
    # fp32 + fp16-emulated correlation for the closest reference numerics
    model = LSegNet(cfg, torch.float32, device, emulate_fp16=True)
    state, text_state = load_reference_checkpoint(args.weights, cfg)
    model.load_state_dict(state)
    tok = ClipBPETokenizer.from_file(args.bpe_vocab, cfg.text.context_length)
    txt = TextFeatureCache(cfg.text, text_state, tok,
                           device=device)(tuple(labels))

    x = np.load(args.ref_input)
    if x.shape[1] == 3:  # NCHW -> NHWC
        x = x.transpose(0, 2, 3, 1)
    ref = np.load(args.ref_logits)
    if ref.shape[1] == len(labels):  # NKHW -> NHWK
        ref = ref.transpose(0, 2, 3, 1)

    with torch.inference_mode():
        out = model(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            device), txt).cpu().numpy()
    diff = np.abs(out - ref)
    agree = (out.argmax(-1) == ref.argmax(-1)).mean()
    print(f"logit max abs diff : {diff.max():.6f}")
    print(f"logit mean abs diff: {diff.mean():.6f}")
    print(f"argmax agreement   : {agree:.6f}")
    ok = diff.max() < MAX_ABS_DIFF and agree > MIN_AGREEMENT
    if ok:
        print("PARITY: PASS")
    else:
        print("PARITY: INSPECT (see per-layer debugging in "
              "utils/checkpoint_convert.py docstrings)")
    return ok


if __name__ == "__main__":
    main()
