"""Interactive open-vocabulary segmentation app (Streamlit) on the
PyTorch/CUDA port: `app.py`'s page, plus `--device`. Upload an image,
type a comma-separated label list, get the overlay and its legend. Text
features are cached per label set (`TextFeatureCache`); the default is
the single-scale predictor, the sidebar switches to the multi-scale +
flip protocol.

    streamlit run lseg_tpu_torch/app.py -- --weights demo_e200.ckpt \\
        --bpe_vocab bpe_simple_vocab_16e6.txt.gz

`load` and `request` are the page's work as plain functions; Streamlit
is imported by `main` only, so the module imports without it.
"""

from __future__ import annotations

import argparse

import torch
from PIL import Image


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", required=True)
    p.add_argument("--bpe_vocab", required=True)
    p.add_argument("--backbone", default="clip_vitl16_384")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    return p.parse_args(argv)


def load(weights: str, bpe_vocab: str, backbone: str, device="cuda"):
    """(model, text cache, predictor, logits_fn) of a reference `.ckpt`:
    the bf16 `LSegNet` of `get_config(backbone)` on `device`."""
    from lseg_tpu_torch import get_config
    from lseg_tpu_torch.engine.serve import make_logits_fn, make_predictor
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.text.cache import TextFeatureCache
    from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer
    from lseg_tpu_torch.utils.checkpoint_convert import (
        load_reference_checkpoint,
    )

    device = torch.device(device)
    cfg = get_config(backbone)
    model = LSegNet(cfg, torch.bfloat16, device)
    state, text_state = load_reference_checkpoint(weights, cfg)
    model.load_state_dict(state)
    tok = ClipBPETokenizer.from_file(bpe_vocab, cfg.text.context_length)
    cache = TextFeatureCache(cfg.text, text_state, tok, device=device)
    return model, cache, make_predictor(model), make_logits_fn(model)


def request(loaded, image, label_str: str, use_tta: bool = False,
            alpha: float = 0.5):
    """One request of the page: `image` (a path, a file object or a PIL
    image) against the comma-separated `label_str` -> (overlay (H, W, 3)
    uint8, [(label, rgb)] of the classes present)."""
    from lseg_tpu_torch.demo import segment, split_labels
    from lseg_tpu_torch.utils.palette import (
        class_palette,
        legend_patches,
        overlay,
    )

    _, cache, predictor, logits_fn = loaded
    labels = split_labels(label_str)
    txt = cache(tuple(labels))
    pil = (image if isinstance(image, Image.Image)
           else Image.open(image)).convert("RGB")
    pred, shown = segment(predictor, logits_fn, txt, pil, use_tta)
    pal = class_palette(len(labels))
    return (overlay(shown, pred, pal, alpha=alpha),
            legend_patches(pred, labels, pal))


def main():
    import streamlit as st

    args = parse_args()
    st.title("LSeg — language-driven segmentation")
    loaded = st.cache_resource(load)(args.weights, args.bpe_vocab,
                                     args.backbone, args.device)
    uploaded = st.file_uploader("image", type=["jpg", "jpeg", "png"])
    label_str = st.text_input("labels (comma-separated)",
                              "dog, grass, other")
    use_tta = st.sidebar.checkbox("multi-scale + flip TTA", value=False)
    alpha = st.sidebar.slider("overlay alpha", 0.0, 1.0, 0.5)
    if uploaded is None or not label_str.strip():
        st.stop()
    image, legend = request(loaded, uploaded, label_str, use_tta, alpha)
    st.image(image, caption="segmentation")
    for name, color in legend:
        st.markdown(
            f'<span style="color: rgb{color}">■</span> {name}',
            unsafe_allow_html=True,
        )


if __name__ == "__main__":
    main()
