"""The port's serving entry points against the JAX package's, the text
cache, and two rules of the port: no JAX at runtime, and no fallback
when the CUDA kernels cannot be built."""

import os
import subprocess
import sys

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
    perturb,
    tiny_fast_config,
    tiny_parity_config,
)

from lseg_tpu.engine import serve as jserve
from lseg_tpu.models.clip_text import CLIPTextEncoder as JText
from lseg_tpu.models.lseg import LSegNet as JNet
from lseg_tpu.ops.correlation import correlate as jcorrelate
from lseg_tpu.ops.resize import upsample2x as jupsample2x
from lseg_tpu.testing import TINY_TEXT
from lseg_tpu_torch.engine.serve import make_logits_fn, make_predictor
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.ops import _build
from lseg_tpu_torch.ops.correlation import correlate
from lseg_tpu_torch.ops.resize import upsample2x
from lseg_tpu_torch.text.cache import TextFeatureCache
from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer
from lseg_tpu_torch.utils.convert import from_jax_text_params, from_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_parity_config()
    x, txt = inputs(0, out_c=cfg.out_c)
    v = jax_lseg_variables(cfg, x, txt)
    return x, txt, v, from_jax_variables(v)


def _jax_labels_batch1(cfg, dtype, v, x, txt):
    pred = jserve.make_predictor(JNet(cfg, dtype=dtype), v)
    return np.concatenate([np.asarray(pred(jnp.asarray(x[i:i + 1]),
                                           jnp.asarray(txt)))
                           for i in range(x.shape[0])])


def test_make_predictor_fp32_matches_jax(setup):
    x, txt, v, sd = setup
    cfg = tiny_parity_config()
    predict = make_predictor(LSegNet(cfg), sd)
    got = predict(x, torch.from_numpy(txt))
    assert got.dtype == torch.int32 and got.shape == (2, 64, 96)
    assert int(got.min()) >= 0 and int(got.max()) < txt.shape[0]
    agree = float(np.mean(got.numpy() ==
                          _jax_labels_batch1(cfg, jnp.float32, v, x, txt)))
    assert agree >= 0.99, agree


def test_make_predictor_bf16_fast_head_within_bound(setup):
    """The fast head's pre-argmax logits by the d_port <= 2 d_ref rule;
    label agreement is printed only (random-init margins are ~0)."""
    x, txt, v, sd = setup
    cfg = tiny_fast_config()
    model = LSegNet(cfg, dtype=torch.bfloat16)
    predict = make_predictor(model, sd)
    labels = predict(x, txt)

    def jax_head(cfg, dtype):
        emb = jax.jit(lambda v, x: JNet(cfg, dtype=dtype).apply(v, x))(
            v, jnp.asarray(x))
        hd = jnp.bfloat16 if cfg.head_dtype == "bfloat16" else jnp.float32
        lg = jcorrelate(emb, jnp.asarray(txt), cfg.logit_scale,
                        compute_dtype=hd)
        return f32(jupsample2x(lg, compute_dtype=hd))

    with torch.inference_mode():
        emb = model(torch.from_numpy(x))
        up = upsample2x(correlate(emb, torch.from_numpy(txt),
                                  cfg.logit_scale,
                                  compute_dtype=torch.bfloat16),
                        compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(torch.argmax(up, -1).int().numpy(),
                                  labels.numpy())
    d_port, d_ref = assert_bf16_bound(
        up.float().numpy(), jax_head(cfg, jnp.bfloat16),
        jax_head(fp32_reference_of(cfg), jnp.float32), "head logits")
    agree = np.mean(labels.numpy() ==
                    _jax_labels_batch1(cfg, jnp.bfloat16, v, x, txt))
    print(f"head logits d_port={d_port} d_ref={d_ref} "
          f"label agreement={agree:.4f}")


def test_make_logits_fn_is_the_model_forward(setup):
    x, txt, _, sd = setup
    model = LSegNet(tiny_parity_config())
    got = make_logits_fn(model, sd)(x, txt)
    with torch.no_grad():
        ref = model(torch.from_numpy(x), torch.from_numpy(txt))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_make_predictor_pallas_head_not_ported(setup):
    """The streamed head (kernels B10 + B11, their plain twins on the CPU)
    is ported: on the fp32 parity config it gives the default head's
    labels, up to logits that tie at fp32 rounding."""
    x, txt, _, sd = setup
    model = LSegNet(tiny_parity_config())
    got = make_predictor(model, sd, use_pallas=True)(x, txt)
    ref = make_predictor(model)(x, txt)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert float((got == ref).float().mean()) >= 0.999


def test_text_feature_cache_hit_miss_and_shapes():
    tok = ClipBPETokenizer.for_tests(TINY_TEXT.context_length)
    v = perturb(JText(TINY_TEXT).init(jax.random.PRNGKey(0),
                                      jnp.zeros((2, 16), jnp.int32)))
    cache = TextFeatureCache(TINY_TEXT, from_jax_text_params(v["params"]),
                             tok, device="cpu")
    a = cache(["cat", "dog", "other"])
    assert a.shape == (3, TINY_TEXT.embed_dim) and a.dtype == torch.float32
    assert cache(["cat", "dog", "other"]) is a          # hit
    b = cache(("dog", "cat"))                           # miss
    assert b.shape == (2, TINY_TEXT.embed_dim)
    torch.testing.assert_close(b[0], a[1])
    assert len(cache._cache) == 2
    pair = cache.pair_features("cat")
    torch.testing.assert_close(pair[1], a[0])
    ref = f32(jax.jit(JText(TINY_TEXT).apply)(v, jnp.asarray(
        tok(["cat", "dog", "other"]))))
    np.testing.assert_allclose(a.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_port_runtime_imports_no_jax():
    code = ("import sys\n"
            "import lseg_tpu_torch.engine.serve, lseg_tpu_torch.text.cache\n"
            "import lseg_tpu_torch.utils.convert\n"
            "assert 'jax' not in sys.modules, sorted(\n"
            "    m for m in sys.modules if m.startswith(('jax', 'flax')))\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: where nvcc is missing, asking for the kernels
    raises, naming nvcc."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_kernels.__wrapped__()
