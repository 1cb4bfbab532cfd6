"""The port's CLIP text tower and tokenizer against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_bf16_bound, f32, perturb

from lseg_tpu.models.clip_text import CLIPTextEncoder as JText
from lseg_tpu.testing import TINY_TEXT
from lseg_tpu.text.tokenizer import ClipBPETokenizer as JTokenizer
from lseg_tpu_torch.models.clip_text import CLIPTextEncoder
from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer
from lseg_tpu_torch.utils.convert import from_jax_text_params

LABELS = ["the cat", "dog", "other", "grass and stone", "plant"]


@pytest.fixture(scope="module")
def setup():
    tokens = ClipBPETokenizer.for_tests(TINY_TEXT.context_length)(LABELS)
    v = perturb(JText(TINY_TEXT).init(jax.random.PRNGKey(0),
                                      jnp.asarray(tokens)))
    return tokens, v


def _jax(v, tokens, dtype):
    return f32(jax.jit(JText(TINY_TEXT, dtype=dtype).apply)(
        v, jnp.asarray(tokens)))


def _port(v, tokens, dtype):
    enc = CLIPTextEncoder(TINY_TEXT, dtype=dtype)
    enc.load_state_dict(from_jax_text_params(v["params"]), strict=True)
    with torch.no_grad():
        return enc(torch.from_numpy(tokens)).float().numpy()


def test_text_encoder_fp32_matches_jax(setup):
    tokens, v = setup
    ref = _jax(v, tokens, jnp.float32)
    got = _port(v, tokens, torch.float32)
    assert got.shape == (len(LABELS), TINY_TEXT.embed_dim)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_text_encoder_bf16_within_bound(setup):
    tokens, v = setup
    assert_bf16_bound(_port(v, tokens, torch.bfloat16),
                      _jax(v, tokens, jnp.bfloat16),
                      _jax(v, tokens, jnp.float32), "text features")


def test_tokenizer_is_the_reference_tokenizer():
    texts = ["the cat", "a dog, other!", "plant grass stone " * 10]
    for ctx in (16, 77):
        np.testing.assert_array_equal(
            ClipBPETokenizer.for_tests(ctx)(texts),
            JTokenizer.for_tests(ctx)(texts))
