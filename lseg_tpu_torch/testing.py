"""Tiny model config for the tests and the synthetic training smoke run
(a copy of `lseg_tpu/testing.py` · `tiny_vit_config`).

Shapes are chosen so every architectural path (4-level reassemble with
up/identity/down resampling, fusion cascade, correlation head) is
exercised at toy cost.
"""

from __future__ import annotations

from lseg_tpu_torch.config import (
    CLIPTextConfig,
    LSegConfig,
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
