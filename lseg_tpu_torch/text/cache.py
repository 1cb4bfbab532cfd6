"""Per-label-set text-feature cache (torch port of
`lseg_tpu/text/cache.py`).

The text tower runs once per distinct label set; the image path takes the
cached (K, C) matrix as a plain argument. Given a `parallel.dist.Mesh`,
the tower is cut over its model group (`parallel.tensor.shard_module_`)
and every rank of the group gets the whole (K, C) matrix.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from lseg_tpu_torch import CLIPTextConfig
from lseg_tpu_torch.models.clip_text import CLIPTextEncoder
from lseg_tpu_torch.parallel.tensor import shard_module_


class TextFeatureCache:
    """labelset (tuple of strings) -> (K, embed_dim) text features on
    `device`; with a `mesh`, the tower cut over its model group (every
    rank of the group must call with the same labels)."""

    def __init__(self, cfg: CLIPTextConfig, state, tokenizer,
                 dtype=torch.float32, device="cuda", mesh=None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.encoder = CLIPTextEncoder(cfg, dtype=dtype, device=self.device)
        self.encoder.load_state_dict(state)
        self.encoder.eval()
        if mesh is not None:
            shard_module_(self.encoder, mesh)
        self._cache: Dict[Tuple[str, ...], torch.Tensor] = {}

    def __call__(self, labels: Sequence[str]) -> torch.Tensor:
        key = tuple(labels)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        tokens = torch.as_tensor(self.tokenizer(list(labels)),
                                 dtype=torch.long, device=self.device)
        with torch.inference_mode():
            feats = self.encoder(tokens)
        self._cache[key] = feats
        return feats

    def pair_features(self, label: str,
                      other: str = "others") -> torch.Tensor:
        """Zero-shot episode head: the ['others', <class>] pair."""
        return self((other, label))


def encode_labels(cfg: CLIPTextConfig, state, tokenizer,
                  labels: Sequence[str], device="cpu",
                  mesh=None) -> np.ndarray:
    """One-shot convenience (no cache): the (K, embed_dim) fp32 text
    features of `labels` as a numpy array, the tower cut over the model
    group of `mesh` if given."""
    return TextFeatureCache(cfg, state, tokenizer, device=device,
                            mesh=mesh)(labels).float().cpu().numpy()
