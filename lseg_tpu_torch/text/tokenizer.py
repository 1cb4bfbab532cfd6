"""The CLIP BPE tokenizer, shared with the reference package.

`lseg_tpu/text/tokenizer.py` is framework-free, but importing it as
`lseg_tpu.text.tokenizer` would run `lseg_tpu/text/__init__.py`, which
imports the JAX text cache. The file is therefore loaded by path, under
a name of this package, so the port uses the reference's tokenizer
itself and never imports JAX.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import lseg_tpu

_NAME = "lseg_tpu_torch.text._clip_bpe"
_PATH = Path(lseg_tpu.__file__).resolve().parent / "text" / "tokenizer.py"


def _load():
    mod = sys.modules.get(_NAME)
    if mod is None:
        spec = importlib.util.spec_from_file_location(_NAME, _PATH)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[_NAME] = mod
    return mod


_mod = _load()
ClipBPETokenizer = _mod.ClipBPETokenizer
