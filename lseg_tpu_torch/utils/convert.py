"""Convert the JAX package's variables into the port's `state_dict`.

`from_jax_variables` takes `LSegNet` variables (`params` +
`batch_stats`) as a nested dict of numpy arrays (and any other model
whose port names follow the JAX tree, as `models.hsnet.HSNet`'s do, with
either backbone); `from_jax_text_params`
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
- the head-major attention leaves of a `tp_layout=True` tree (qkv kernel
  (D, 3, H, hd), bias (3, H, hd); proj kernel (H, hd, D)) reshape to the
  flat (D, 3D), (3D,) and (D, D) they were made from
  (`to_tp_layout` of `utils/checkpoint_convert.py`), then transpose as
  any kernel;
- LayerNorm/BatchNorm `scale` -> `weight`, batch stats `mean`/`var` ->
  `running_mean`/`running_var`; raw parameters keep their names.

`to_jax_variables` is the inverse: a port `state_dict` back to the JAX
tree (`.npz` export and import, `train.checkpoint`), for the float and
the quantized trees alike, with the ViT attention in the head-major
layout when given `tp_heads` (the heads of a `tp_layout=True` tree).
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
    if path[-2:] == ("qkv", "bias") and a.ndim == 3:
        return a.reshape(-1)                 # head-major (3, H, hd)
    if path[-1] not in ("kernel", "kernel_q"):
        return a
    if path[-2:] == ("qkv", "kernel") and a.ndim == 4:
        return a.reshape(a.shape[0], -1).T   # head-major (D, 3, H, hd)
    if path[-2:] == ("proj", "kernel") and a.ndim == 3:
        return a.reshape(-1, a.shape[-1]).T  # head-major (H, hd, D)
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
    """`LSegNet` variables ({'params', 'batch_stats'}; ViT or ResNet
    backbone) -> state_dict."""
    out: Dict[str, torch.Tensor] = {}
    params = dict(variables["params"])
    vit = dict(params.pop("vit", {}))
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


def _jax_leaf(path: tuple, a: np.ndarray) -> Tuple[str, np.ndarray]:
    """(JAX leaf name, array in the JAX layout) of one port entry."""
    leaf = path[-1]
    if leaf == "weight" and a.ndim == 1:
        return "scale", a
    if leaf not in ("weight", "weight_q"):
        return leaf, a
    name = "kernel" if leaf == "weight" else "kernel_q"
    if "patch_embed" in path:
        p = int(round((a.shape[0] / 3) ** 0.5))
        return name, a.reshape(p, p, 3, a.shape[-1])
    if a.ndim == 2:
        return name, a.T
    if path[-2:-1] == ("resample",) and a.shape[-1] != 3:
        return name, a.transpose(0, 2, 3, 1)   # TokenUpsample
    return name, a.transpose(2, 3, 1, 0)       # OIHW -> HWIO


def _put(tree: dict, path: tuple, a) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = a


def _head_major(path: tuple, a: np.ndarray, heads: int) -> np.ndarray:
    """A ViT attention leaf (JAX layout, flat) in the `tp_layout=True`
    layout of `heads` heads."""
    if path[-3:-1] == ("attn", "qkv") and path[-1] in ("weight", "bias"):
        return a.reshape(*a.shape[:-1], 3, heads, -1)
    if path[-3:] == ("attn", "proj", "weight"):
        return a.reshape(heads, -1, a.shape[-1])
    return a


def to_jax_variables(state, hooks=(), tp_heads: int = None) -> dict:
    """Port `LSegNet` state_dict -> {'params', 'batch_stats'} of numpy
    arrays (int8 leaves int8, the rest fp32), the ViT blocks stacked into
    the scan segments that end at `hooks` (none for a ResNet model); with
    `tp_heads`, the float attention leaves in the head-major layout of a
    `tp_layout=True` tree of that many heads."""
    params: dict = {}
    stats: dict = {}
    blocks: Dict[tuple, list] = {}
    for name, t in state.items():
        a = t.detach().cpu()
        a = (a.numpy() if a.dtype == torch.int8
             else a.float().numpy())
        path = tuple(name.split("."))
        if path[-1] in ("running_mean", "running_var"):
            _put(stats, path[:-1] + (path[-1][len("running_"):],), a)
            continue
        leaf, a = _jax_leaf(path, a)
        if tp_heads is not None and path[:2] == ("vit", "blocks"):
            a = _head_major(path, a, tp_heads)
        if path[:2] == ("vit", "blocks"):
            k = int(path[2])
            seg = next(s for s, h in enumerate(hooks) if k <= h)
            key = ("vit", f"seg{seg}", "blocks") + path[3:-1] + (leaf,)
            blocks.setdefault(key, []).append((k, a))
        else:
            _put(params, path[:-1] + (leaf,), a)
    for key, items in blocks.items():
        _put(params, key, np.stack([a for _, a in sorted(items)]))
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out
