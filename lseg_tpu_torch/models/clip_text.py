"""CLIP text encoder (torch port of `lseg_tpu/models/clip_text.py`).

token embedding -> learned positional embedding -> pre-norm blocks with
a causal mask and QuickGELU MLPs -> final LayerNorm (eps 1e-5) -> the
activation at each sequence's EOT token (argmax of the token ids) ->
linear projection to the joint embedding width. It runs once per label
set, never on the image path. Cut over a model group
(`parallel.tensor.shard_module_`), each block runs this rank's heads and
hidden units, Megatron's layout, as the JAX package's tensor-parallel
rules shard the tower.
"""

from __future__ import annotations

import torch
from torch import nn

from lseg_tpu_torch import CLIPTextConfig
from lseg_tpu_torch.models.layers import Dense, LayerNorm
from lseg_tpu_torch.parallel.tensor import copy_to_model, row_parallel


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CausalSelfAttention(nn.Module):
    """Multi-head attention with a causal mask (fused in-projection,
    separate out-projection)."""

    def __init__(self, width: int, heads: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.heads = heads
        self.head_dim = width // heads
        self.group = None
        self.dtype = dtype
        self.in_proj = Dense(width, 3 * width, dtype, device)
        self.out_proj = Dense(width, width, dtype, device)

    def shard(self, group, n: int) -> None:
        """Run this rank's `heads / n` heads of a model group."""
        self.group = group
        self.heads //= n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, _ = x.shape
        h, hd = self.heads, self.head_dim
        d = h * hd
        x = copy_to_model(x, self.group)
        q, k, v = self.in_proj(x).reshape(n, t, 3, h, hd).unbind(2)
        s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float())
        s = s * hd ** -0.5
        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~causal, float("-inf"))
        attn = torch.softmax(s, dim=-1).to(self.dtype)
        out = torch.einsum("nhqk,nkhd->nqhd", attn.float(), v.float())
        return row_parallel(self.out_proj, out.to(self.dtype).reshape(n, t, d),
                            self.group)


class TextBlock(nn.Module):
    """x += attn(ln_1(x)); x += c_proj(quick_gelu(c_fc(ln_2(x))))."""

    def __init__(self, width: int, heads: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.ln_1 = LayerNorm(width, 1e-5, dtype, device)
        self.attn = CausalSelfAttention(width, heads, dtype, device)
        self.ln_2 = LayerNorm(width, 1e-5, dtype, device)
        self.c_fc = Dense(width, 4 * width, dtype, device)
        self.c_proj = Dense(4 * width, width, dtype, device)
        self.group = None

    def shard(self, group, n: int) -> None:
        """c_fc column- and c_proj row-parallel over a model group."""
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        y = quick_gelu(self.c_fc(copy_to_model(self.ln_2(x), self.group)))
        return x + row_parallel(self.c_proj, y, self.group)


class CLIPTextEncoder(nn.Module):
    """(K, context_length) token ids -> (K, embed_dim) text features."""

    def __init__(self, cfg: CLIPTextConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype

        def param(*shape):
            return nn.Parameter(torch.empty(
                shape, dtype=torch.float32, device=device),
                requires_grad=False)

        self.token_embedding = param(cfg.vocab_size, cfg.width)
        self.positional_embedding = param(cfg.context_length, cfg.width)
        self.resblocks = nn.ModuleList(
            TextBlock(cfg.width, cfg.heads, dtype, device)
            for _ in range(cfg.layers))
        self.ln_final = LayerNorm(cfg.width, 1e-5, dtype, device)
        self.text_projection = param(cfg.width, cfg.embed_dim)

    def reset_parameters(self, generator=None):
        self.token_embedding.normal_(0.0, 0.02, generator=generator)
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.text_projection.normal_(0.0, self.cfg.width ** -0.5,
                                     generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        k, t = tokens.shape
        tokens = tokens.long()
        x = self.token_embedding[tokens].to(self.dtype)
        x = x + self.positional_embedding[:t].to(self.dtype)
        for blk in self.resblocks:
            x = blk(x)
        x = self.ln_final(x)
        eot = torch.argmax(tokens, dim=-1)
        x = x[torch.arange(k, device=x.device), eot]
        proj = self.text_projection.to(self.dtype)
        return torch.matmul(x.float(), proj.float()).to(self.dtype)
