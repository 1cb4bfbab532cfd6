"""lseg_tpu_torch — the PyTorch/CUDA port of lseg_tpu for NVIDIA Hopper.

The JAX package `lseg_tpu` stays the reference; this package mirrors its
module names (`ops/`, `models/`, `text/`, `engine/`, `utils/`) so each
counterpart is easy to find. It imports `torch` and never `jax`, and
nothing of `lseg_tpu`: the framework-free modules it needs are its own
copies (`config`, `testing.tiny_vit_config` and `tiny_rn_config`,
`data/` with the packaged `label_files/`, `utils/sinks`,
`text/tokenizer`). The model reads its
config by attribute only, so a config object of either package serves.

Hand-written Hopper kernels live in `csrc/` and are built with `nvcc`
at first use (`ops/_build.py`); each has a plain PyTorch twin beside
its wrapper (`ops/patch_embed.py`, `ops/flash_attention.py`,
`ops/ln_quant.py`, `ops/head1_correlate.py`, `ops/fused_correlate.py`,
`ops/upsample_argmax.py`). The int8 serving layer (`quantize_tree`,
`calibrate_act_scales`, the int8 dense and conv products) is
`ops/quant.py`.
"""

from lseg_tpu_torch.config import (  # noqa: F401
    CLIP_TEXT_VITB32,
    CLIPTextConfig,
    LSegConfig,
    ViTConfig,
    fast_serving,
    flat_flash_eligible,
    get_config,
)
from lseg_tpu_torch.data.labels import get_labels  # noqa: F401

__version__ = "0.1.0"
