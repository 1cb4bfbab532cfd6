"""Convert the JAX package's variables into the port's `state_dict`.

`from_jax_variables` takes `LSegNet` variables (`params` +
`batch_stats`) as a nested dict of numpy arrays; `from_jax_text_params`
takes `CLIPTextEncoder` params. Both return {name: fp32 tensor} for
`load_state_dict`, which rounds each entry to its parameter's dtype, the
same cast the reference makes at every call.

The rules:
- scan-stacked blocks (`vit/seg{i}/blocks/*`, `resblocks/*`; leading
  axis = block index) unstack into `vit.blocks.{k}` / `resblocks.{k}`,
  numbered on across the segments;
- `nn.Dense` kernels (in, out) -> `weight` (out, in);
- conv kernels HWIO -> OIHW;
- the TokenUpsample kernel (C_in, s, s, C_out) -> ConvTranspose2d's
  (C_in, C_out, s, s); it is told apart from the stride-2 (3, 3, C, C)
  conv that can sit at the same place by its equal middle dimensions;
- the patch-embed kernel (p, p, C, D) flattens to (p*p*C, D);
- LayerNorm/BatchNorm `scale` -> `weight`, batch stats `mean`/`var` ->
  `running_mean`/`running_var`; raw parameters keep their names.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_RENAME = {"scale": "weight", "mean": "running_mean",
           "var": "running_var", "kernel": "weight"}


def _flatten(tree, prefix=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _convert_leaf(path: tuple, a: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return a
    if "patch_embed" in path:
        return a.reshape(-1, a.shape[-1])
    if a.ndim == 2:
        return a.T
    if a.ndim == 4:
        if path[-2] == "resample" and a.shape[1] == a.shape[2] != 3:
            return a.transpose(0, 3, 1, 2)   # TokenUpsample
        return a.transpose(3, 2, 0, 1)       # HWIO -> OIHW
    raise ValueError(f"unexpected kernel {'/'.join(path)} {a.shape}")


def _name(path: tuple) -> str:
    return ".".join(path[:-1] + (_RENAME.get(path[-1], path[-1]),))


def _stacked(tree, key: str, out_prefix: tuple, start: int,
             out: Dict[str, torch.Tensor]) -> int:
    """Unstack one scan-stacked subtree; returns the next block index."""
    n = None
    for path, a in _flatten(tree):
        n = a.shape[0] if n is None else n
        if a.shape[0] != n:
            raise ValueError(f"{key}/{'/'.join(path)}: stack of "
                             f"{a.shape[0]}, expected {n}")
        for j in range(n):
            name = _name(out_prefix + (str(start + j),) + path)
            out[name] = _tensor(_convert_leaf(path, a[j]))
    return start + (n or 0)


def _plain(tree, out: Dict[str, torch.Tensor]) -> None:
    for path, a in _flatten(tree):
        out[_name(path)] = _tensor(_convert_leaf(path, a))


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """`LSegNet` variables ({'params', 'batch_stats'}) -> state_dict."""
    out: Dict[str, torch.Tensor] = {}
    params = dict(variables["params"])
    vit = dict(params.pop("vit"))
    segs = sorted((k for k in vit if re.fullmatch(r"seg\d+", k)),
                  key=lambda k: int(k[3:]))
    start = 0
    for seg in segs:
        start = _stacked(vit.pop(seg)["blocks"], f"vit/{seg}",
                         ("vit", "blocks"), start, out)
    _plain({"vit": vit, **params}, out)
    _plain(variables.get("batch_stats", {}), out)
    return out


def from_jax_text_params(params) -> Dict[str, torch.Tensor]:
    """`CLIPTextEncoder` params (the `params` collection) ->
    state_dict."""
    out: Dict[str, torch.Tensor] = {}
    rest = dict(params)
    _stacked(rest.pop("resblocks"), "resblocks", ("resblocks",), 0, out)
    _plain(rest, out)
    return out
