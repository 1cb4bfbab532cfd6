"""The port's whole LSegNet against the JAX package's on one converted
variables tree: the fp32 parity config to 1e-3 in the logits, the bf16
`fast_serving(quant=False)` config by the d_port <= 2 d_ref rule, and
every output mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    assert_bf16_bound,
    f32,
    fp32_reference_of,
    inputs,
    jax_lseg_variables,
    tiny_fast_config,
    tiny_parity_config,
)

from lseg_tpu.models.lseg import LSegNet as JNet
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.utils.convert import from_jax_variables


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_parity_config()
    x, txt = inputs(0, out_c=cfg.out_c)
    v = jax_lseg_variables(cfg, x, txt)
    return x, txt, v, from_jax_variables(v)


def _port(cfg, dtype, sd):
    model = LSegNet(cfg, dtype=dtype)
    model.load_state_dict(sd)
    return model.eval()


def _jax(cfg, dtype, v, *args, **kw):
    fn = jax.jit(lambda v, *a: JNet(cfg, dtype=dtype).apply(v, *a, **kw))
    return fn(v, *[jnp.asarray(a) for a in args])


def test_state_dict_covers_every_parameter(setup):
    *_, v, sd = setup
    model = LSegNet(tiny_parity_config())
    model.load_state_dict(sd, strict=True)
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(v))
    n_port = sum(t.numel() for t in model.state_dict().values())
    assert n_port == n_jax


def test_lseg_fp32_parity_logits(setup):
    x, txt, v, sd = setup
    cfg = tiny_parity_config()
    ref = f32(_jax(cfg, jnp.float32, v, x, txt))
    with torch.no_grad():
        got = _port(cfg, torch.float32, sd)(torch.from_numpy(x),
                                            torch.from_numpy(txt))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    dev = float(np.max(np.abs(got.numpy() - ref)))
    assert dev <= 1e-3, f"max abs logit deviation {dev}"


def test_lseg_bf16_fast_logits_within_bound(setup):
    x, txt, v, sd = setup
    cfg = tiny_fast_config()
    ref_bf16 = f32(_jax(cfg, jnp.bfloat16, v, x, txt))
    ref_fp32 = f32(_jax(fp32_reference_of(cfg), jnp.float32, v, x, txt))
    with torch.no_grad():
        got = _port(cfg, torch.bfloat16, sd)(torch.from_numpy(x),
                                             torch.from_numpy(txt))
    d_port, d_ref = assert_bf16_bound(got.numpy(), ref_bf16, ref_fp32,
                                      "logits")
    print(f"logits: d_port={d_port} d_ref={d_ref}")


def test_lseg_pixel_embedding_and_halfres(setup):
    x, txt, v, sd = setup
    cfg = tiny_parity_config()
    model = _port(cfg, torch.float32, sd)
    with torch.no_grad():
        emb = model(torch.from_numpy(x))
        half = model(torch.from_numpy(x), torch.from_numpy(txt),
                     return_halfres=True)
    np.testing.assert_allclose(emb.numpy(), f32(_jax(cfg, jnp.float32, v, x)),
                               rtol=1e-4, atol=1e-4)
    assert emb.shape == (2, 32, 48, cfg.out_c)
    ref_half = f32(_jax(cfg, jnp.float32, v, x, txt, return_halfres=True))
    np.testing.assert_allclose(half.numpy(), ref_half, rtol=0, atol=1e-3)


def test_lseg_return_argmax_matches_jitted_batch1(setup):
    """Labels against the jitted batch-1 JAX program (batch-8 or eager
    programs reassociate and flip random-init ties)."""
    x, txt, v, sd = setup
    cfg = tiny_parity_config()
    model = _port(cfg, torch.float32, sd)
    with torch.no_grad():
        full = model(torch.from_numpy(x), torch.from_numpy(txt),
                     return_argmax=True)
        half = model(torch.from_numpy(x), torch.from_numpy(txt),
                     return_argmax=True, return_halfres=True)
    assert full.dtype == torch.int32 and full.shape == (2, 64, 96)
    assert half.shape == (2, 32, 48)
    np.testing.assert_array_equal(full.numpy()[:, ::2, ::2], half.numpy())
    ref = np.concatenate([np.asarray(_jax(cfg, jnp.float32, v, x[i:i + 1],
                                          txt, return_argmax=True))
                          for i in range(2)])
    agree = float(np.mean(full.numpy() == ref))
    assert agree >= 0.99, agree


@pytest.mark.parametrize("quant", ["static", "static_cal"])
def test_lseg_builds_int8_configs(quant):
    from lseg_tpu.config import fast_serving

    cfg = fast_serving(tiny_parity_config(), quant=quant)
    model = LSegNet(cfg, dtype=torch.bfloat16)
    assert model.vit.blocks[0].attn.ln_fused
    assert model.vit.blocks[0].ln_quant
    assert hasattr(model.vit.blocks[0], "act_scale") == (quant == "static_cal")
    assert model.head1.weight_q.dtype == torch.int8


def test_lseg_fused_argmax_head_needs_b5(setup):
    """head_fused=True in argmax mode runs kernel B5 (its plain twin on
    the CPU), as the reference does: the labels are the argmax of B4's
    half-res logits on the same path1, up to logits that tie at bf16."""
    import dataclasses

    from lseg_tpu.config import fast_serving
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_argmax_fused,
    )

    x, txt, *_ = setup
    cfg = dataclasses.replace(fast_serving(tiny_parity_config(), "static"),
                              head_fused=True)
    model = random_init_(LSegNet(cfg, dtype=torch.bfloat16),
                         torch.Generator().manual_seed(0))
    calls = []
    model._fused_argmax_head = (lambda f: lambda *a: calls.append(1) or f(
        *a))(model._fused_argmax_head)
    launches = head1_correlate_argmax_fused.launches
    with torch.no_grad():
        pred = model(torch.from_numpy(x), torch.from_numpy(txt),
                     return_argmax=True, return_halfres=True)
        logits = model(torch.from_numpy(x), torch.from_numpy(txt),
                       return_halfres=True)
    assert calls == [1] and pred.dtype == torch.int32
    assert head1_correlate_argmax_fused.launches == launches  # CPU: plain
    agree = float((pred == logits.float().argmax(-1)).float().mean())
    assert agree >= 0.99, agree
