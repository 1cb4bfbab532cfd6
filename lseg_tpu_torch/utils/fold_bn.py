"""Serving-time BatchNorm folding (torch port of
`lseg_tpu/utils/fold_bn.py`).

Eval-mode BatchNorm after a conv is a per-output-channel affine:

    bn(conv(x, W)) = conv(x, W * g/s) + (b - m * g/s),  s = sqrt(v + eps)

so the BN disappears into the conv's weight and bias, exactly in exact
arithmetic. The folded `state_dict` loads into a model built with
`use_bn=False`, whose RCU convs carry a bias: the structure folding
produces.

    state = model.state_dict()                        # use_bn=True
    folded = fold_bn_tree(state)
    LSegNet(dataclasses.replace(cfg, use_bn=False)).load_state_dict(folded)

The port's `state_dict` holds the running statistics beside the
parameters, so the scope of the folding is chosen by `keep`: BatchNorms
under those module prefixes stay (the JAX package folds the BatchNorms
whose statistics it is given). A ResNet model's backbone has no
`use_bn` switch, so its BatchNorms stay: `keep=("resnet.",)`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

_EPS = 1e-5  # flax nn.BatchNorm's default, and torch's


def _conv_of(bn: str) -> str:
    """The conv sibling a BatchNorm folds into: `bnX` -> `convX`,
    `down_bn` -> `down_conv`."""
    parent, _, leaf = bn.rpartition(".")
    conv = "down_conv" if leaf == "down_bn" else "conv" + leaf[2:]
    return f"{parent}.{conv}" if parent else conv


def fold_bn_tree(state: Dict[str, torch.Tensor],
                 keep: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """Fold every (convX, bnX) / (down_conv, down_bn) sibling pair of
    `state` into a bias-carrying conv (fp32); the BatchNorm entries are
    removed. Pairs under a prefix of `keep`, and every other entry, pass
    through unchanged."""
    bns = [name[:-len(".running_mean")] for name in state
           if name.endswith(".running_mean")]
    pairs = {}
    for bn in bns:
        leaf = bn.rpartition(".")[2]
        if not (leaf.startswith("bn") or leaf == "down_bn"):
            continue
        if bn.startswith(tuple(keep)):
            continue
        conv = _conv_of(bn)
        if f"{conv}.weight" in state:
            pairs[conv] = bn
    out = {}
    folded_bns = set(pairs.values())
    for name, t in state.items():
        mod, _, leaf = name.rpartition(".")
        if mod in folded_bns:
            continue
        if mod in pairs and leaf in ("weight", "bias"):
            continue  # written below
        out[name] = t
    for conv, bn in pairs.items():
        g = state[f"{bn}.weight"].float()
        b = state[f"{bn}.bias"].float()
        m = state[f"{bn}.running_mean"].float()
        v = state[f"{bn}.running_var"].float()
        s = g / torch.sqrt(v + _EPS)
        w = state[f"{conv}.weight"].float()
        bias = b - m * s
        if f"{conv}.bias" in state:
            bias = bias + state[f"{conv}.bias"].float() * s
        out[f"{conv}.weight"] = w * s.reshape(-1, *([1] * (w.dim() - 1)))
        out[f"{conv}.bias"] = bias
    return out
