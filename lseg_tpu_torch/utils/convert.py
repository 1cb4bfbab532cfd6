"""Convert the JAX package's variables into the port's `state_dict`.

`from_jax_variables` takes `LSegNet` variables (`params` +
`batch_stats`) as a nested dict of numpy arrays; `from_jax_text_params`
takes `CLIPTextEncoder` params. Both return {name: tensor} for
`load_state_dict`: int8 leaves stay int8, everything else is fp32, which
`load_state_dict` rounds to its parameter's dtype, the same cast the
reference makes at every call. A training model
(`LSegNet(..., param_dtype=torch.float32)`) keeps the fp32 values as its
master parameters and casts them at each call instead, so its forward
equals the serving model's; the `batch_stats` become the BatchNorm
running statistics that its train mode goes on updating.

The rules:
- scan-stacked blocks (`vit/seg{i}/blocks/*`, `resblocks/*`; leading
  axis = block index) unstack into `vit.blocks.{k}` / `resblocks.{k}`,
  numbered on across the segments;
- `nn.Dense` kernels (in, out) -> `weight` (out, in);
- conv kernels HWIO -> OIHW;
- int8 `kernel_q` leaves (a `quantize_tree` serving tree) -> `weight_q`,
  transposed exactly as `kernel` is; the `scale` beside a `kernel_q` is the
  per-output-channel weight scale and keeps its name, as does each 0-d
  `act_scale` (stacked `(L,)` under the scan segments, so it unstacks with
  the blocks);
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
           "var": "running_var", "kernel": "weight", "kernel_q": "weight_q"}


def _flatten(tree, prefix=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    """(path, array) of every leaf; the `scale` of a quantized leaf set
    comes out as `scale_q` so that it keeps its name (`_name`)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            a = np.asarray(v)
            key = "scale_q" if k == "scale" and "kernel_q" in tree else k
            yield prefix + (key,), (a if a.dtype == np.int8
                                    else a.astype(np.float32))


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def _convert_leaf(path: tuple, a: np.ndarray) -> np.ndarray:
    if path[-1] not in ("kernel", "kernel_q"):
        return a
    if "patch_embed" in path:
        return a.reshape(-1, a.shape[-1])
    if a.ndim == 2:
        return a.T
    if a.ndim == 4:
        if path[-2:-1] == ("resample",) and a.shape[1] == a.shape[2] != 3:
            return a.transpose(0, 3, 1, 2)   # TokenUpsample
        return a.transpose(3, 2, 0, 1)       # HWIO -> OIHW
    raise ValueError(f"unexpected kernel {'/'.join(path)} {a.shape}")


def _name(path: tuple) -> str:
    leaf = "scale" if path[-1] == "scale_q" else _RENAME.get(path[-1],
                                                             path[-1])
    return ".".join(path[:-1] + (leaf,))


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
