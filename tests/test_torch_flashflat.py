"""The `fast_flashflat` path (bench.py's rung: `fast_serving(cfg, 'static')`
with `attn_impl='flashflat'`, `ln_quant_fused=False`, `mlp_act_cal=False`:
int8 qkv and projection products around kernel B6, the flat flash
attention) against the JAX package's, on a carried-across quantized tree
of the tiny parity config: the half-res logits within the bf16 bound and
the labels of bench.py's call against the jitted batch-1 JAX program, as
tests/test_torch_flashq.py holds the `fast_flashq` rung. The flax models
of the JAX package are imported inside the fixtures and helpers that use
them: the card machine has JAX but no flax."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    assert_bf16_bound,
    f32,
    fp32_reference_of,
    inputs,
    jax_lseg_variables,
    tiny_parity_config,
)

from lseg_tpu.config import fast_serving
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.ops.flash_attention import flash_attention_flat
from lseg_tpu_torch.utils.convert import from_jax_variables


def _t(a):
    return torch.from_numpy(np.array(a))


def flashflat_config(base):
    """bench.py's `fast_flashflat` rung on `base`."""
    cfg = fast_serving(base, "static")
    return dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, attn_impl="flashflat", ln_quant_fused=False,
        mlp_act_cal=False))


@pytest.fixture(scope="module")
def carried():
    """A perturbed tiny head_dim-64 tree quantized in JAX as bench.py
    quantizes the 'static' rungs (no activation scales, no calibration),
    and its conversion."""
    from lseg_tpu.ops.quant import quantize_tree as j_quantize_tree

    base = tiny_parity_config()
    x, txt = inputs(0, out_c=base.out_c)
    v = jax_lseg_variables(base, x, txt)
    cfg = flashflat_config(base)
    vq = dict(v)
    vq["params"] = j_quantize_tree(v["params"], decoder=True,
                                   act_scale=False, mlp_act_scale=False)
    vq = jax.tree_util.tree_map(np.asarray, vq)
    return x, txt, cfg, vq, from_jax_variables(vq)


def _port(cfg, sd):
    model = LSegNet(cfg, dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True)
    return model


def _jax_apply(cfg, dtype, v, *args, **kw):
    from lseg_tpu.models.lseg import LSegNet as JNet

    return jax.jit(lambda v, *a: JNet(cfg, dtype=dtype).apply(v, *a, **kw))(
        v, *[jnp.asarray(a) for a in args])


def test_fast_flashflat_runs_b6_per_block(carried):
    """The rung's ViT takes the flat attention of B6 (its plain version on
    the CPU) once per block, with int8 qkv and projection weights."""
    x, txt, cfg, _, sd = carried
    model = _port(cfg, sd)
    blk = model.vit.blocks[0]
    assert blk.attn.flat and not blk.attn.qkv_fused and not blk.ln_quant
    assert "vit.blocks.0.attn.qkv.weight_q" in model.state_dict()
    calls = []
    real = flash_attention_flat

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    import lseg_tpu_torch.models.vit as vit_mod

    vit_mod.flash_attention_flat = counting
    try:
        with torch.no_grad():
            model(_t(x), _t(txt), return_argmax=True)
    finally:
        vit_mod.flash_attention_flat = real
    assert len(calls) == cfg.vit.depth


def test_fast_flashflat_halfres_logits_within_bf16_bound(carried):
    """Half-res logits of the port against JAX's on the same tree, by
    d_port <= 2 d_ref + 0.0625, d_ref = JAX bf16 vs JAX fp32."""
    x, txt, cfg, vq, sd = carried
    ref_bf16 = f32(_jax_apply(cfg, jnp.bfloat16, vq, x, txt,
                              return_halfres=True))
    ref_fp32 = f32(_jax_apply(fp32_reference_of(cfg), jnp.float32, vq, x,
                              txt, return_halfres=True))
    with torch.no_grad():
        got = _port(cfg, sd)(_t(x), _t(txt), return_halfres=True)
    assert got.dtype == torch.bfloat16 and got.shape == ref_bf16.shape
    got = got.float().numpy()
    d_port = float(np.max(np.abs(got - ref_bf16)))
    d_ref = float(np.max(np.abs(ref_bf16 - ref_fp32)))
    print(f"fast_flashflat: d_port={d_port} d_ref={d_ref}")
    assert d_port <= 2.0 * d_ref + 0.0625, (d_port, d_ref)


def test_fast_flashflat_argmax_matches_jitted_batch1(carried):
    """bench.py's call, `model(x, txt, return_argmax=True)`, against the
    jitted batch-1 JAX program, with the 0.985 gate of the other int8
    rungs (random-init margins are near ties that the int8 grids
    amplify)."""
    x, txt, cfg, vq, sd = carried
    with torch.no_grad():
        got = _port(cfg, sd)(_t(x), _t(txt), return_argmax=True)
    assert got.dtype == torch.int32 and got.shape == (2, 64, 96)
    ref = np.concatenate([np.asarray(_jax_apply(
        cfg, jnp.bfloat16, vq, x[i:i + 1], txt, return_argmax=True))
        for i in range(2)])
    agree = float(np.mean(got.numpy() == ref))
    print(f"fast_flashflat labels vs JAX batch-1 program {agree:.4f}")
    assert agree >= 0.985, agree
