"""Tiny model configs for the tests and the synthetic training smoke run,
and the writers of a reference-format checkpoint and BPE vocabulary
(copies of `lseg_tpu/testing.py` · `tiny_vit_config`, `tiny_rn_config`,
`write_reference_ckpt` and `write_reference_vocab`, verbatim apart from
their imports; the writers use only numpy and torch).

Shapes are chosen so every architectural path (4-level reassemble with
up/identity/down resampling, fusion cascade, correlation head) is
exercised at toy cost.
"""

from __future__ import annotations

from lseg_tpu_torch.config import (
    CLIPTextConfig,
    LSegConfig,
    ResNetConfig,
    ViTConfig,
)

# vocab covers ClipBPETokenizer.for_tests() ids (512 byte symbols +
# merges + specials ≈ 525).
TINY_TEXT = CLIPTextConfig(
    vocab_size=1024, context_length=16, width=32, layers=2, heads=2,
    embed_dim=64,
)


def tiny_vit_config(**kw) -> LSegConfig:
    import dataclasses

    base = LSegConfig(
        backbone="tiny_vit",
        features=32,
        out_c=64,
        vit=ViTConfig(
            patch_size=16,
            embed_dim=64,
            depth=4,
            num_heads=2,
            # depth 4 / one block per segment: halves the dominant
            # per-test compile+run cost on 1-CPU hosts while still
            # exercising the segmented scan, all 4 reassemble levels
            # and the fusion cascade
            hooks=(0, 1, 2, 3),
            post_channels=(16, 32, 64, 64),
            resample=(4.0, 2.0, 1.0, 0.5),
            pretrain_grid=4,
        ),
        text=TINY_TEXT,
    )
    return dataclasses.replace(base, **kw) if kw else base


def tiny_rn_config(**kw) -> LSegConfig:
    import dataclasses

    base = LSegConfig(
        backbone="tiny_rn",
        features=32,
        out_c=64,
        resnet=ResNetConfig(layers=(1, 1, 1, 1)),
        text=TINY_TEXT,
    )
    return dataclasses.replace(base, **kw) if kw else base


def write_reference_ckpt(path, cfg, seed: int = 0) -> None:
    """Write a synthetic REFERENCE-FORMAT Lightning checkpoint FILE.

    Produces a genuine torch zip-pickle `.ckpt` whose `state_dict`
    carries the reference module tree's exact key names under the
    Lightning `net.` prefix — timm ViT under `net.pretrained.model.*`
    (lseg_vit.py:408-535), Sequential `act_postprocess` pipelines
    (lseg_vit.py:446-523), decoder under `net.scratch.*`
    (lseg_blocks.py:60-110, lseg_net.py:126-156), and the frozen CLIP
    text tower under `net.clip_pretrained.*` — exactly what
    `utils.checkpoint_convert.load_reference_checkpoint` parses.

    This is the real-checkpoint readiness drill's artifact builder
    (VERDICT r3 item 4): the first run with the user-supplied
    `demo_e200.ckpt` should exercise zero new code.
    """
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)

    def t(*shape, scale=0.1):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32))

    vit = cfg.vit
    d = vit.embed_dim
    g0 = vit.pretrain_grid
    sd = {
        "net.pretrained.model.cls_token": t(1, 1, d),
        "net.pretrained.model.pos_embed": t(1, 1 + g0 * g0, d),
        "net.pretrained.model.patch_embed.proj.weight": t(
            d, 3, vit.patch_size, vit.patch_size),
        "net.pretrained.model.patch_embed.proj.bias": t(d),
    }
    for i in range(vit.hooks[-1] + 1):
        b = f"net.pretrained.model.blocks.{i}"
        h = int(d * vit.mlp_ratio)
        sd[f"{b}.norm1.weight"] = 1 + t(d)
        sd[f"{b}.norm1.bias"] = t(d)
        sd[f"{b}.attn.qkv.weight"] = t(3 * d, d)
        sd[f"{b}.attn.qkv.bias"] = t(3 * d)
        sd[f"{b}.attn.proj.weight"] = t(d, d)
        sd[f"{b}.attn.proj.bias"] = t(d)
        sd[f"{b}.norm2.weight"] = 1 + t(d)
        sd[f"{b}.norm2.bias"] = t(d)
        sd[f"{b}.mlp.fc1.weight"] = t(h, d)
        sd[f"{b}.mlp.fc1.bias"] = t(h)
        sd[f"{b}.mlp.fc2.weight"] = t(d, h)
        sd[f"{b}.mlp.fc2.bias"] = t(d)
    for i in range(4):
        p = f"net.pretrained.act_postprocess{i + 1}"
        ch = vit.post_channels[i]
        sd[f"{p}.0.project.0.weight"] = t(d, 2 * d)
        sd[f"{p}.0.project.0.bias"] = t(d)
        sd[f"{p}.3.weight"] = t(ch, d, 1, 1)
        sd[f"{p}.3.bias"] = t(ch)
        r = vit.resample[i]
        if r > 1:
            sd[f"{p}.4.weight"] = t(ch, ch, int(r), int(r))
            sd[f"{p}.4.bias"] = t(ch)
        elif r < 1:
            sd[f"{p}.4.weight"] = t(ch, ch, 3, 3)
            sd[f"{p}.4.bias"] = t(ch)
    f = cfg.features
    for i in range(4):
        sd[f"net.scratch.layer{i + 1}_rn.weight"] = t(
            f, vit.post_channels[i], 3, 3)
    for i in range(1, 5):
        base = f"net.scratch.refinenet{i}"
        for u in ("resConfUnit1", "resConfUnit2"):
            sd[f"{base}.{u}.conv1.weight"] = t(f, f, 3, 3)
            sd[f"{base}.{u}.conv2.weight"] = t(f, f, 3, 3)
            for bn in ("bn1", "bn2"):
                sd[f"{base}.{u}.{bn}.weight"] = 1 + 0.1 * t(f)
                sd[f"{base}.{u}.{bn}.bias"] = t(f)
                sd[f"{base}.{u}.{bn}.running_mean"] = t(f)
                sd[f"{base}.{u}.{bn}.running_var"] = (
                    1 + 0.1 * t(f)).abs()
        sd[f"{base}.out_conv.weight"] = t(f, f, 1, 1)
        sd[f"{base}.out_conv.bias"] = t(f)
    sd["net.scratch.head1.weight"] = t(cfg.out_c, f, 1, 1)
    sd["net.scratch.head1.bias"] = t(cfg.out_c)

    tc = cfg.text
    w = tc.width
    sd["net.clip_pretrained.token_embedding.weight"] = t(
        tc.vocab_size, w, scale=0.02)
    sd["net.clip_pretrained.positional_embedding"] = t(
        tc.context_length, w, scale=0.01)
    for i in range(tc.layers):
        b = f"net.clip_pretrained.transformer.resblocks.{i}"
        sd[f"{b}.ln_1.weight"] = 1 + 0.1 * t(w)
        sd[f"{b}.ln_1.bias"] = t(w)
        sd[f"{b}.attn.in_proj_weight"] = t(3 * w, w)
        sd[f"{b}.attn.in_proj_bias"] = t(3 * w)
        sd[f"{b}.attn.out_proj.weight"] = t(w, w)
        sd[f"{b}.attn.out_proj.bias"] = t(w)
        sd[f"{b}.ln_2.weight"] = 1 + 0.1 * t(w)
        sd[f"{b}.ln_2.bias"] = t(w)
        sd[f"{b}.mlp.c_fc.weight"] = t(4 * w, w)
        sd[f"{b}.mlp.c_fc.bias"] = t(4 * w)
        sd[f"{b}.mlp.c_proj.weight"] = t(w, 4 * w)
        sd[f"{b}.mlp.c_proj.bias"] = t(w)
    sd["net.clip_pretrained.ln_final.weight"] = 1 + 0.1 * t(w)
    sd["net.clip_pretrained.ln_final.bias"] = t(w)
    sd["net.clip_pretrained.text_projection"] = t(w, tc.embed_dim)
    sd["net.logit_scale"] = torch.tensor(2.6593)  # ln(1/0.07), frozen

    torch.save({"state_dict": sd, "epoch": 200, "global_step": 1234},
               path)


def write_reference_vocab(path) -> None:
    """Write a tiny CLIP-format BPE merges file (gzip text, version
    header line + 'left right' merge lines — the layout of
    `bpe_simple_vocab_16e6.txt.gz` that `ClipBPETokenizer.from_file`
    parses). Token ids stay < 1024, matching `tiny_vit_test`'s text
    vocab table."""
    import gzip

    merges = [
        ("t", "h"), ("th", "e</w>"), ("c", "a"), ("ca", "t</w>"),
        ("a", "t</w>"), ("d", "o"), ("do", "g</w>"), ("e", "r</w>"),
        ("o", "t"), ("h", "er</w>"), ("ot", "her</w>"),
        ("g", "r"), ("gr", "a"), ("gra", "s"), ("gras", "s</w>"),
        ("s", "t"), ("st", "o"), ("sto", "n"), ("ston", "e</w>"),
        ("p", "l"), ("pl", "a"), ("pla", "n"), ("plan", "t</w>"),
    ]
    with gzip.open(path, "wt", encoding="utf-8") as fh:
        fh.write("#version: synthetic test vocab\n")
        for a, b in merges:
            fh.write(f"{a} {b}\n")
