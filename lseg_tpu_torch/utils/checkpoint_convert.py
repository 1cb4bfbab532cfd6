"""Load reference (PyTorch-Lightning / raw `state_dict`) LSeg checkpoints
into the port (torch port of `lseg_tpu/utils/checkpoint_convert.py`).

The reference ships Lightning `.ckpt` dicts whose `state_dict` holds keys
under a `net.` prefix, plus raw `torch.save(state_dict)` exports. The
reader below is a copy of the JAX package's, verbatim apart from its
imports: it unpacks the zip archive into numpy arrays without
`torch.load`, so a Lightning checkpoint whose pickled `hyper_parameters`
name classes of lang-seg's own modules (not importable here) still loads:
the unpickler stubs every class it does not know.

The port's modules keep PyTorch's layouts (Linear `(out, in)`, Conv2d
OIHW, ConvTranspose2d `(in, out, k, k)`, the fused qkv / in-projection
stacked `(3 D, D)`), so the map from lang-seg's keys to
`LSegNet.state_dict()` is a renaming, as the JAX package's `convert_lseg`
followed by `utils.convert.from_jax_variables` is in two steps: the
transposes into flax's layouts and back cancel. Only the patch embedding
changes layout (`(D, C, p, p)` -> the `(p * p * C, D)` rows of the
patchify product). The per-block ViT weights keep their block index; the
`act_postprocess` pipelines map as lang-seg builds them (0 = readout,
3 = 1x1 conv, 4 = resample); the ResNet-101 stages as lang-seg repackages
torchvision's (`pretrained.layer1` = Sequential(conv1, bn1, relu, maxpool,
layer1), so its indices 0, 1 and 4; `pretrained.layer2..4` the bare
layers); BatchNorm running statistics become the buffers of the port's
`BatchNorm`. Tensors the reference trains but never uses
(`refinenet4.resConfUnit1`, the ViT blocks after the last hook and its
final norm, `logit_scale`) are dropped, as in the JAX package.

Three initialisations of the reference have key maps of their own, each
the JAX package's converter followed by `from_jax_variables`:
`torchvision_resnet_key_map` (a torchvision resnet50/101 `state_dict`
into `ResNetBackbone`), `torchvision_vgg16_key_map` (torchvision's vgg16
`features` into HSNet's `VGG16Features`) and `clip_visual_key_map` (the
CLIP visual tower transplanted into `DenseViT`); `prefixed` puts a
submodule's map under its name in a whole model (HSNet's `backbone.`).
"""

from __future__ import annotations

import io
import pickle
import zipfile
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from lseg_tpu_torch.config import LSegConfig
from lseg_tpu_torch.models.vgg import vgg16_conv_indices

# ---------------------------------------------------------------------------
# torch-free .pt/.ckpt reader
# ---------------------------------------------------------------------------

_DTYPES = {
    "FloatStorage": np.float32,
    "DoubleStorage": np.float64,
    "HalfStorage": np.float16,
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
    "BFloat16Storage": None,  # handled specially
}


class _TorchUnpickler(pickle.Unpickler):
    """Minimal unpickler for torch checkpoint archives: resolves storages
    from the zip and rebuilds tensors as numpy arrays."""

    def __init__(self, data: bytes, archive: zipfile.ZipFile, prefix: str):
        super().__init__(io.BytesIO(data))
        self.archive = archive
        self.prefix = prefix

    def find_class(self, module, name):
        if module == "torch._utils" and name in (
            "_rebuild_tensor_v2", "_rebuild_tensor",
        ):
            return _rebuild_tensor
        if module == "torch" and name.endswith("Storage"):
            return _StorageType(name)
        if module == "collections" and name == "OrderedDict":
            return dict
        if module == "torch.serialization":
            return lambda *a, **k: None
        if module == "torch" and name in ("float32", "float16", "bfloat16",
                                          "int64", "float64"):
            return name
        # Anything else (Lightning callbacks etc.) -> inert stub
        return _Stub

    def persistent_load(self, pid):
        typename, storage_type, key, _location, numel = (
            pid[0], pid[1], pid[2], pid[3], pid[4]
        )
        assert typename == "storage", typename
        name = f"{self.prefix}data/{key}"
        raw = self.archive.read(name)
        if storage_type.name == "BFloat16Storage":
            u16 = np.frombuffer(raw, dtype=np.uint16, count=numel)
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(
                raw, dtype=_DTYPES[storage_type.name], count=numel
            )
        return arr


class _StorageType:
    def __init__(self, name):
        self.name = name


class _Stub:
    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        self.state = state


def _rebuild_tensor(storage, storage_offset, size, stride, *args):
    arr = storage[storage_offset: storage_offset + int(np.prod(size))
                  if size else storage_offset + 1]
    if not size:
        return arr.reshape(())
    return np.lib.stride_tricks.as_strided(
        arr, shape=size,
        strides=[s * arr.itemsize for s in stride],
    ).copy()


def load_torch_file(path: str) -> Dict[str, np.ndarray]:
    """Load a torch-serialized checkpoint (zip format) as numpy arrays,
    without importing torch."""
    with zipfile.ZipFile(path) as zf:
        pkl_name = next(
            n for n in zf.namelist() if n.endswith("data.pkl")
        )
        prefix = pkl_name[: -len("data.pkl")]
        obj = _TorchUnpickler(zf.read(pkl_name), zf, prefix).load()
    return obj


def extract_state_dict(ckpt: Any) -> Dict[str, np.ndarray]:
    """Pull the flat name->tensor dict out of a Lightning ckpt or raw
    state_dict, normalizing away `net.` / `module.` prefixes."""
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    out = {}
    for k, v in ckpt.items():
        if not isinstance(v, np.ndarray):
            continue
        for pre in ("net.", "module.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# lang-seg keys -> the port's state_dict
# ---------------------------------------------------------------------------

def _same(a: np.ndarray) -> np.ndarray:
    return a


def patch_rows(w: np.ndarray) -> np.ndarray:
    """Conv2d patch weight (D, C, p, p) -> the port's (p * p * C, D)."""
    return w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0])


# port name -> (reference key, layout change)
KeyMap = Dict[str, Tuple[str, Callable[[np.ndarray], np.ndarray]]]


def _module(out: KeyMap, port: str, ref: str, leaves=("weight", "bias")):
    for leaf in leaves:
        out[f"{port}.{leaf}"] = (f"{ref}.{leaf}", _same)


_BN = ("weight", "bias", "running_mean", "running_var")


def _resnet_blocks(out: KeyMap, port: str, layers, stage_prefix,
                   has_down: Callable[[str, int], bool]) -> None:
    """The bottleneck blocks of `ResNetBackbone` under `port` from the
    torchvision block keys `{stage_prefix(stage)}.{b}.*`; `has_down(key,
    b)` says whether block b has a projection shortcut."""
    for stage, n_blocks in enumerate(layers):
        for b in range(n_blocks):
            ref = f"{stage_prefix(stage)}.{b}"
            mod = f"{port}layer{stage + 1}_block{b}"
            for c in (1, 2, 3):
                _module(out, f"{mod}.conv{c}", f"{ref}.conv{c}", ("weight",))
                _module(out, f"{mod}.bn{c}", f"{ref}.bn{c}", _BN)
            if has_down(ref, b):
                _module(out, f"{mod}.down_conv", f"{ref}.downsample.0",
                        ("weight",))
                _module(out, f"{mod}.down_bn", f"{ref}.downsample.1", _BN)


def _vit_key_map(out: KeyMap, vit) -> None:
    m = "pretrained.model"
    out.update({
        "vit.cls_token": (f"{m}.cls_token", _same),
        "vit.pos_embed": (f"{m}.pos_embed", _same),
        "vit.patch_embed.weight": (f"{m}.patch_embed.proj.weight",
                                   patch_rows),
        "vit.patch_embed.bias": (f"{m}.patch_embed.proj.bias", _same),
    })
    for i in range(vit.hooks[-1] + 1):
        for sub in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1",
                    "mlp.fc2"):
            _module(out, f"vit.blocks.{i}.{sub}", f"{m}.blocks.{i}.{sub}")


def lseg_key_map(cfg: LSegConfig) -> KeyMap:
    """Every entry of an `LSegNet(cfg).state_dict()` (float tree) and the
    lang-seg key it comes from. A ResNet model takes every stage's
    blocks from `cfg.resnet.layers` (the reference's converter reads
    ResNet-101's (3, 4, 23, 3)), each stage's first block with its
    projection shortcut."""
    vit = cfg.vit
    out: KeyMap = {}
    if cfg.is_vit:
        _vit_key_map(out, vit)
    else:
        _module(out, "resnet.conv1", "pretrained.layer1.0", ("weight",))
        _module(out, "resnet.bn1", "pretrained.layer1.1", _BN)
        _resnet_blocks(
            out, "resnet.", cfg.resnet.layers,
            lambda s: "pretrained.layer1.4" if s == 0
            else f"pretrained.layer{s + 1}",
            lambda ref, b: b == 0)
    for i in range(1, 5):
        if cfg.is_vit:
            ref = f"pretrained.act_postprocess{i}"
            if cfg.readout == "project":
                _module(out, f"reassemble{i}.readout.project",
                        f"{ref}.0.project.0")
            _module(out, f"reassemble{i}.proj", f"{ref}.3")
            if vit.resample[i - 1] != 1:
                _module(out, f"reassemble{i}.resample", f"{ref}.4")
        _module(out, f"scratch.layer{i}_rn", f"scratch.layer{i}_rn",
                ("weight",))
        fusion = f"scratch.refinenet{i}"
        for r, unit in ((1, "resConfUnit1"), (2, "resConfUnit2")):
            if r == 1 and i == 4:
                continue  # fusion block 4 has no skip input
            for c in (1, 2):
                _module(out, f"refinenet{i}.rcu{r}.conv{c}",
                        f"{fusion}.{unit}.conv{c}",
                        ("weight",) if cfg.use_bn else ("weight", "bias"))
                if cfg.use_bn:
                    _module(out, f"refinenet{i}.rcu{r}.bn{c}",
                            f"{fusion}.{unit}.bn{c}", _BN)
        _module(out, f"refinenet{i}.out_conv", f"{fusion}.out_conv")
    _module(out, "head1", "scratch.head1")
    if cfg.arch_option in (1, 2):
        # one shared 3x3 single-channel conv, (1, 1, 3, 3) on both sides
        _module(out, "head_block", "scratch.head_block.depthwise.depthwise")
    return out


def torchvision_resnet_key_map(
    sd: Dict[str, np.ndarray], layers=(3, 4, 23, 3), prefix: str = "",
) -> KeyMap:
    """Every entry of `ResNetBackbone(ResNetConfig(layers)).state_dict()`
    and the key of a torchvision resnet50/101 `state_dict` (bare naming
    under `prefix`: conv1, bn1, layer{1..4}.{b}.*) it comes from; a block
    takes its projection shortcut where `sd` holds one (JAX package:
    `convert_torchvision_resnet`)."""
    out: KeyMap = {}
    _module(out, "conv1", f"{prefix}conv1", ("weight",))
    _module(out, "bn1", f"{prefix}bn1", _BN)
    _resnet_blocks(out, "", layers, lambda s: f"{prefix}layer{s + 1}",
                   lambda ref, b: f"{ref}.downsample.0.weight" in sd)
    return out


def torchvision_vgg16_key_map(prefix: str = "features.") -> KeyMap:
    """Every entry of `VGG16Features().state_dict()` and the key of a
    torchvision vgg16 `state_dict` (`{prefix}{idx}.weight` / `.bias`) it
    comes from: the same `features` index, the same OIHW layout (JAX
    package: `convert_torchvision_vgg16`)."""
    out: KeyMap = {}
    for idx in vgg16_conv_indices():
        _module(out, f"conv{idx}", f"{prefix}{idx}")
    return out


def prefixed(key_map: KeyMap, prefix: str) -> KeyMap:
    """`key_map` with every port name under `prefix` (a submodule's map
    for the whole model's `state_dict`, e.g. HSNet's `backbone.`)."""
    return {prefix + name: src for name, src in key_map.items()}


def _zeros_like_rows(w: np.ndarray) -> np.ndarray:
    return np.zeros((w.shape[0],), np.float32)


def _token(a: np.ndarray) -> np.ndarray:
    return a.reshape(1, 1, -1)


def _batched(a: np.ndarray) -> np.ndarray:
    return a[None]


def clip_visual_key_map(sd: Dict[str, np.ndarray], cfg: LSegConfig,
                        prefix: str = "clip_pretrained.visual") -> KeyMap:
    """The CLIP visual tower's weights for `DenseViT(cfg.vit)` (the
    reference's 'clip' / 'clip_fixed' transplant init; JAX package:
    `convert_clip_visual_to_vit`): class_embedding -> cls_token, conv1 ->
    patch_embed (bias zero: CLIP's conv1 has none), in_proj -> qkv,
    ln_1 / ln_2 -> norm1 / norm2, the MLP's c_fc / c_proj -> fc1 / fc2.
    The position embedding comes along where the grids agree; otherwise
    the map leaves `pos_embed` out and the model keeps its own. Names are
    the `DenseViT` module's own (load with `strict=False`)."""
    vit = cfg.vit
    out: KeyMap = {
        "cls_token": (f"{prefix}.class_embedding", _token),
        "patch_embed.weight": (f"{prefix}.conv1.weight", patch_rows),
        "patch_embed.bias": (f"{prefix}.conv1.weight", _zeros_like_rows),
    }
    pos = sd.get(f"{prefix}.positional_embedding")
    if pos is not None and pos.shape[0] == 1 + vit.pretrain_grid ** 2:
        out["pos_embed"] = (f"{prefix}.positional_embedding", _batched)
    for i in range(vit.hooks[-1] + 1):
        ref = f"{prefix}.transformer.resblocks.{i}"
        for port, sub in (("norm1", "ln_1"), ("attn.proj", "attn.out_proj"),
                          ("norm2", "ln_2"), ("mlp.fc1", "mlp.c_fc"),
                          ("mlp.fc2", "mlp.c_proj")):
            _module(out, f"blocks.{i}.{port}", f"{ref}.{sub}")
        for leaf in ("weight", "bias"):
            out[f"blocks.{i}.attn.qkv.{leaf}"] = (
                f"{ref}.attn.in_proj_{leaf}", _same)
    return out


def text_key_map(sd: Dict[str, np.ndarray],
                 layers: Optional[int] = None) -> KeyMap:
    """Every entry of `CLIPTextEncoder.state_dict()` and the
    `clip_pretrained.*` key it comes from; `layers` defaults to the
    number of residual blocks in `sd`."""
    base = "clip_pretrained"
    if layers is None:
        layers = 1 + max(
            int(k.split(".")[3])
            for k in sd
            if k.startswith(f"{base}.transformer.resblocks.")
        )
    out: KeyMap = {
        "token_embedding": (f"{base}.token_embedding.weight", _same),
        "positional_embedding": (f"{base}.positional_embedding", _same),
        "text_projection": (f"{base}.text_projection", _same),
    }
    _module(out, "ln_final", f"{base}.ln_final")
    for i in range(layers):
        ref = f"{base}.transformer.resblocks.{i}"
        for port, sub in (("ln_1", "ln_1"), ("attn.out_proj",
                                             "attn.out_proj"),
                          ("ln_2", "ln_2"), ("c_fc", "mlp.c_fc"),
                          ("c_proj", "mlp.c_proj")):
            _module(out, f"resblocks.{i}.{port}", f"{ref}.{sub}")
        for leaf in ("weight", "bias"):
            out[f"resblocks.{i}.attn.in_proj.{leaf}"] = (
                f"{ref}.attn.in_proj_{leaf}", _same)
    return out


def apply_key_map(sd: Dict[str, np.ndarray],
                  key_map: KeyMap) -> Dict[str, torch.Tensor]:
    """{port name: fp32 tensor} from the reference tensors."""
    return {name: torch.from_numpy(np.array(
        fn(sd[ref]).astype(np.float32), order="C"))
        for name, (ref, fn) in key_map.items()}


def load_reference_checkpoint(
    path: str, cfg: LSegConfig
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One-call loader: reference .ckpt path -> (LSegNet state_dict,
    CLIPTextEncoder state_dict)."""
    sd = extract_state_dict(load_torch_file(path))
    return (apply_key_map(sd, lseg_key_map(cfg)),
            apply_key_map(sd, text_key_map(sd)))
