"""lseg_tpu_torch — the PyTorch/CUDA port of lseg_tpu for NVIDIA Hopper.

The JAX package `lseg_tpu` stays the reference; this package mirrors its
module names (`ops/`, `models/`, `text/`, `engine/`, `utils/`) so each
counterpart is easy to find. It imports `torch` and never `jax`.

The framework-free parts of the reference are shared, not forked: the
typed configuration (`lseg_tpu.config`) and the packaged label lists
(`lseg_tpu.data.labels`) import no JAX and are re-exported here, so
callers of the port name only this package.

Hand-written Hopper kernels live in `csrc/` and are built with `nvcc`
at first use (`ops/_build.py`); each has a plain PyTorch twin beside
its wrapper (`ops/patch_embed.py`, `ops/flash_attention.py`).
"""

from lseg_tpu.config import (  # noqa: F401
    CLIP_TEXT_VITB32,
    CLIPTextConfig,
    LSegConfig,
    ViTConfig,
    fast_serving,
    flat_flash_eligible,
    get_config,
)
from lseg_tpu.data.labels import get_labels  # noqa: F401

__version__ = "0.1.0"
