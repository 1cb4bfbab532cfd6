"""Kernel B7 (the backward of flat flash attention) and the gradient path
through it: the plain twin against the Pallas backward in interpret mode,
the autograd.Function against autograd of plain softmax attention, the
port's ViT gradients against `jax.grad` of the JAX `DenseViT` with
`attn_impl='flashflat'`, and (on a card) the kernel against its plain
twin."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import cuda_device, f32  # noqa: F401

from lseg_tpu.ops.pallas_attention import _flash_flat_bwd_impl
from lseg_tpu.testing import tiny_vit_config
from lseg_tpu_torch.models.vit import DenseViT
from lseg_tpu_torch.ops.flash_attention import (
    flash_attention_flat,
    flash_attention_flat_bwd,
    flash_attention_flat_bwd_plain,
    flash_attention_flat_fn,
    flash_attention_flat_plain,
)
from lseg_tpu_torch.utils.convert import from_jax_variables

SCALE = 64 ** -0.5


def _inputs(seed, n=2, t=40, heads=2):
    rng = np.random.RandomState(seed)
    d = heads * 64
    qkv = rng.randn(n, t, 3 * d).astype(np.float32)
    do = rng.randn(n, t, d).astype(np.float32)
    return qkv, do


@pytest.mark.parametrize("valid_len", [None, 33], ids=["full", "vl33"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_matches_pallas_interpret(dtype, valid_len):
    """Same (qkv, O, dO) into the Pallas backward (interpret mode) and the
    plain twin. fp32: both are the same fp32 function summed in another
    order. bf16: the same rounding points, but pn and ds round to bf16
    and a sum taken in another order can flip one rounding; 2e-2 of
    max|ref| is the reference's own bound for its kernels."""
    qkv, do = _inputs(0)
    tdt = getattr(torch, dtype)
    q_t = torch.from_numpy(qkv).to(tdt)
    d_t = torch.from_numpy(do).to(tdt)
    with torch.no_grad():
        o_t, lse = flash_attention_flat_plain(q_t, 2, SCALE, valid_len,
                                              return_lse=True)
    got = f32(flash_attention_flat_bwd_plain(q_t, o_t, d_t, lse, 2, SCALE,
                                             valid_len).float())
    jdt = jnp.dtype(dtype)
    ref = f32(_flash_flat_bwd_impl(
        jnp.asarray(f32(q_t.float()), jdt), jnp.asarray(f32(o_t.float()), jdt),
        jnp.asarray(f32(d_t.float()), jdt), 2, SCALE, valid_len, True))
    assert got.shape == ref.shape == (2, 40, 384)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        for name, sl in (("dq", slice(0, 128)), ("dk", slice(128, 256)),
                         ("dv", slice(256, 384))):
            err = np.abs(got[..., sl] - ref[..., sl]).max()
            bound = 2e-2 * np.abs(ref[..., sl]).max()
            assert err <= bound, f"{name}: {err} > {bound}"
    if valid_len is not None:  # masked keys carry no gradient
        assert not got[:, valid_len:, 128:].any()


def _softmax_attention(qkv, heads, valid_len):
    n, t, _ = qkv.shape
    q, k, v = qkv.reshape(n, t, 3, heads, 64).unbind(2)
    s = torch.einsum("nqhd,nkhd->nhqk", q, k) * SCALE
    s = s.masked_fill(torch.arange(t) >= valid_len, float("-inf"))
    return torch.einsum("nhqk,nkhd->nqhd", s.softmax(-1), v).reshape(
        n, t, heads * 64)


@pytest.mark.parametrize("valid_len", [40, 33])
def test_function_grad_matches_autograd(valid_len):
    """fp32 through `flash_attention_flat_fn` against autograd of softmax
    attention in fp64. Its residuals are (qkv, O, lse), O and lse the
    plain forward's own."""
    qkv, do = _inputs(1)
    x = torch.from_numpy(qkv).requires_grad_()
    out = flash_attention_flat_fn(x, 2, SCALE, valid_len)
    saved = out.grad_fn.saved_tensors
    with torch.no_grad():
        o_ref, lse_ref = flash_attention_flat_plain(
            torch.from_numpy(qkv), 2, SCALE, valid_len, return_lse=True)
    assert len(saved) == 3 and saved[2].shape == (2, 2, 40)
    torch.testing.assert_close(saved[1], o_ref, rtol=0, atol=0)
    torch.testing.assert_close(saved[2], lse_ref, rtol=0, atol=0)
    out.backward(torch.from_numpy(do))
    x64 = torch.from_numpy(qkv).double().requires_grad_()
    ref = _softmax_attention(x64, 2, valid_len)
    ref.backward(torch.from_numpy(do).double())
    torch.testing.assert_close(out.double(), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(x.grad.double(), x64.grad, rtol=1e-5,
                               atol=1e-5)


def test_bwd_wrapper_needs_lse_off_the_cpu():
    """Off the CPU the backward kernel reads the forward's lse and has no
    route that recomputes it: a call without lse raises before any device
    dispatch (checked on the meta device, which the sandbox has); on the
    CPU the plain version runs without it."""
    qkv = torch.zeros(1, 8, 384, device="meta")
    o = torch.zeros(1, 8, 128, device="meta")
    with pytest.raises(ValueError, match="lse"):
        flash_attention_flat_bwd(qkv, o, o, None, 2, SCALE)
    q, d = _inputs(2, n=1, t=8)
    qt, dt = torch.from_numpy(q), torch.from_numpy(d)
    ot = flash_attention_flat_plain(qt, 2, SCALE)
    torch.testing.assert_close(
        flash_attention_flat_bwd(qt, ot, dt, None, 2, SCALE),
        flash_attention_flat_bwd_plain(qt, ot, dt, None, 2, SCALE), rtol=0,
        atol=0)


def test_raw_calls_refuse_tensors_that_require_grad():
    """The wrappers and plain versions have no autograd: a tensor that
    requires grad must not go through them with its gradient cut."""
    qkv = torch.randn(1, 8, 384, requires_grad=True)
    for fn in (flash_attention_flat, flash_attention_flat_plain):
        with pytest.raises(RuntimeError, match="requires grad"):
            fn(qkv, 2, SCALE)
    o = torch.randn(1, 8, 128)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_attention_flat_bwd(qkv, o, o, None, 2, SCALE)
    with torch.no_grad():
        assert flash_attention_flat(qkv, 2, SCALE).shape == (1, 8, 128)


@pytest.fixture(scope="module")
def vit_grads():
    """jax.grad of the JAX flashflat DenseViT (Pallas backward in
    interpret mode) at tiny_vit_config with embed 128 and 2 heads, the
    shapes of tests/test_pallas_ops.py's flashflat VJP test."""
    from lseg_tpu.models.vit import DenseViT as JViT

    base = tiny_vit_config()
    cfg = dataclasses.replace(base.vit, embed_dim=128, num_heads=2,
                              attn_impl="flashflat")
    rng = np.random.RandomState(0)
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    model = JViT(cfg)
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def loss(params):
        taps, _ = model.apply({"params": params}, jnp.asarray(x))
        return sum(jnp.sum(t * t) for t in taps) * 1e-3

    g = jax.jit(jax.grad(loss))(v["params"])
    def port(tree):
        sd = from_jax_variables({"params": {"vit": tree}})
        return {k[len("vit."):]: t for k, t in sd.items()}

    return cfg, x, port(v["params"]), port(g)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_vit_grads_match_jax_flashflat(vit_grads, remat):
    """The port's fp32 flashflat DenseViT (unpadded T, gradient through
    `FlashAttentionFlat`) against jax.grad of the padded JAX one, with the
    tolerance of the reference's own flashflat-vs-XLA gradient check."""
    cfg, x, params, grads = vit_grads
    vit = DenseViT(cfg, torch.float32, remat=remat)
    vit.load_state_dict(params)
    for p in vit.parameters():
        p.requires_grad_(True)
    taps, _ = vit(torch.from_numpy(x))
    (sum((t * t).sum() for t in taps) * 1e-3).backward()
    got = dict(vit.named_parameters())
    assert set(got) == set(grads)
    for name, ref in grads.items():
        np.testing.assert_allclose(got[name].grad.numpy(), ref.numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,heads,valid_len",
                         [(2, 40, 2, None), (2, 130, 4, 100),
                          (1, 901, 16, None)])
def test_bwd_kernel_matches_plain_on_card(cuda_device, n, t, heads,
                                          valid_len):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    d = heads * 64
    qkv = torch.randn(n, t, 3 * d, device=cuda_device, generator=g).to(
        torch.bfloat16)
    do = torch.randn(n, t, d, device=cuda_device, generator=g).to(
        torch.bfloat16)
    o, lse = flash_attention_flat(qkv, heads, SCALE, valid_len,
                                  return_lse=True)
    got = flash_attention_flat_bwd(qkv, o, do, lse, heads, SCALE, valid_len)
    ref = flash_attention_flat_bwd_plain(qkv, o, do, lse, heads, SCALE,
                                         valid_len)
    torch.cuda.synchronize()
    for sl in (slice(0, d), slice(d, 2 * d), slice(2 * d, 3 * d)):
        err = (got[..., sl].float() - ref[..., sl].float()).abs().max()
        assert err <= 2e-2 * ref[..., sl].float().abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("t,valid_len", [(40, None), (130, 100), (197, None),
                                         (901, None)])
def test_bwd_kernel_with_lse_at_tma_edges(cuda_device, t, valid_len):
    """B7 fed B6's lse, at the edges TMA zero-fills: T below one tile, a
    ragged last tile with masked keys, ViT-B/16's 197, the flagship 901.
    Each of dq, dk and dv within 2e-2 of max|plain| (chip_smoke.py's
    FLASH_BWD_REL); keys past valid_len get no gradient."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    heads = 4
    d = heads * 64
    qkv = torch.randn(2, t, 3 * d, device=cuda_device, generator=g).to(
        torch.bfloat16)
    do = torch.randn(2, t, d, device=cuda_device, generator=g).to(
        torch.bfloat16)
    o, lse = flash_attention_flat(qkv, heads, SCALE, valid_len,
                                  return_lse=True)
    got = flash_attention_flat_bwd(qkv, o, do, lse, heads, SCALE, valid_len)
    ref = flash_attention_flat_bwd_plain(qkv, o, do, None, heads, SCALE,
                                         valid_len)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    for sl in (slice(0, d), slice(d, 2 * d), slice(2 * d, 3 * d)):
        err = (got[..., sl].float() - ref[..., sl].float()).abs().max()
        assert err <= 2e-2 * ref[..., sl].float().abs().max()
    if valid_len is not None:
        assert not got[:, valid_len:, d:].float().any()


@pytest.mark.gpu
def test_kernels_launch_from_a_fresh_thread(cuda_device):
    """B6 and B7 encode their TMA tensor maps on the calling host thread.
    A fresh thread of the caller's (as autograd's device worker can be)
    may have no current CUDA context yet: the launch must bind one and
    give the same results as from the main thread."""
    import threading

    g = torch.Generator(device=cuda_device).manual_seed(3)
    qkv = torch.randn(2, 197, 3 * 256, device=cuda_device, generator=g).to(
        torch.bfloat16)
    do = torch.randn(2, 197, 256, device=cuda_device, generator=g).to(
        torch.bfloat16)
    o, lse = flash_attention_flat(qkv, 4, SCALE, return_lse=True)
    ref = flash_attention_flat_bwd(qkv, o, do, lse, 4, SCALE)
    got = {}

    def work():
        try:
            got["o"] = flash_attention_flat(qkv, 4, SCALE)
            got["d"] = flash_attention_flat_bwd(qkv, o, do, lse, 4, SCALE)
        except Exception as e:  # noqa: BLE001 (reported below)
            got["error"] = e

    t = threading.Thread(target=work)
    t.start()
    t.join()
    assert "error" not in got, got.get("error")
    torch.cuda.synchronize()
    torch.testing.assert_close(got["o"], o, rtol=0, atol=0)
    torch.testing.assert_close(got["d"], ref, rtol=0, atol=0)


@pytest.mark.gpu
def test_function_kernel_grads_match_plain_on_card(cuda_device):
    """The autograd.Function on the card: forward B6 and backward B7 are
    each launched once, and the gradient agrees with the plain path's."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(2, 197, 3 * 256, device=cuda_device, generator=g).to(
        torch.bfloat16)
    do = torch.randn(2, 197, 256, device=cuda_device, generator=g).to(
        torch.bfloat16)
    grads = []
    for plain in (False, True):
        x = qkv.clone().requires_grad_()
        f0 = flash_attention_flat.launches
        b0 = flash_attention_flat_bwd.launches
        flash_attention_flat_fn(x, 4, SCALE, plain=plain).backward(do)
        launched = (flash_attention_flat.launches - f0,
                    flash_attention_flat_bwd.launches - b0)
        assert launched == ((0, 0) if plain else (1, 1))
        grads.append(x.grad.float())
    torch.cuda.synchronize()
    err = (grads[0] - grads[1]).abs().max()
    assert err <= 2e-2 * grads[1].abs().max()


# ---- the fp32 modes of B6 and B7 (an fp32 model's route) ----

# fp32 kernels against their plain versions: every step in fp32 on both
# sides, summed in another order, the softmax rescaled by the running
# row maximum and the backward reading the forward's lse: the scores
# agree to a few fp32 ulps (~2e-6 at |s| ~ 1), so each P to ~2e-6
# relative, and the weighted averages to 2e-6 of max|v| (< 5 for randn):
# O within 2e-5 + 1e-4 |plain|, lse within 1e-5, each of dq, dk, dv
# within 1e-4 of max|plain| (chip_smoke.py's FLASH_FP32_* constants).
FP32_RTOL, FP32_ATOL, FP32_LSE_ATOL, FP32_BWD_REL = 1e-4, 2e-5, 1e-5, 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,heads,valid_len",
                         [(2, 40, 2, None), (2, 130, 4, 100),
                          (1, 901, 16, None), (2, 64, 2, None),
                          (2, 65, 2, None), (2, 129, 2, 100),
                          (1, 65, 4, None)])
def test_fp32_kernels_match_plain_on_card(cuda_device, n, t, heads,
                                          valid_len):
    """B6 and B7 on fp32 qkv launch their fp32 modes (the wrappers do not
    raise, nothing is rounded to bf16) and agree with the plain twins."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    d = heads * 64
    qkv = torch.randn(n, t, 3 * d, device=cuda_device, generator=g)
    do = torch.randn(n, t, d, device=cuda_device, generator=g)
    f0, b0 = flash_attention_flat.launches, flash_attention_flat_bwd.launches
    o, lse = flash_attention_flat(qkv, heads, SCALE, valid_len,
                                  return_lse=True)
    got = flash_attention_flat_bwd(qkv, o, do, lse, heads, SCALE, valid_len)
    assert (flash_attention_flat.launches - f0,
            flash_attention_flat_bwd.launches - b0) == (1, 1)
    ref_o, ref_lse = flash_attention_flat_plain(qkv, heads, SCALE, valid_len,
                                                return_lse=True)
    ref = flash_attention_flat_bwd_plain(qkv, ref_o, do, None, heads, SCALE,
                                         valid_len)
    torch.cuda.synchronize()
    assert o.dtype == got.dtype == torch.float32
    torch.testing.assert_close(o, ref_o, rtol=FP32_RTOL, atol=FP32_ATOL)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=FP32_LSE_ATOL)
    for sl in (slice(0, d), slice(d, 2 * d), slice(2 * d, 3 * d)):
        err = (got[..., sl] - ref[..., sl]).abs().max()
        assert err <= FP32_BWD_REL * ref[..., sl].abs().max()
    if valid_len is not None:
        assert not got[:, valid_len:, d:].any()


# B7's fp32 mode (csrc/flash_attention_flat_bwd_fp32.cu) emulated on the
# CPU: mma.sync m16n8k8 tf32 on its PTX fragment layout, fed by the
# kernel's own fragment indices (g = lane / 4, t = lane % 4) for its 8
# warps (rows 16 (w % 4).., score columns 32 (w / 4)..), every operand
# split into TF32 hi and lo, the three products issued in the kernel's
# order into a truncating accumulator, the two halves of each row group
# added with round to nearest at the end.
_LANE = np.arange(32)
_G, _T = _LANE // 4, _LANE % 4
_A_RC = [(_G, _T), (_G + 8, _T), (_G, _T + 4), (_G + 8, _T + 4)]
_B_KN = [(_T, _G), (_T + 4, _G)]
_C_RC = [(_G, 2 * _T), (_G, 2 * _T + 1), (_G + 8, 2 * _T),
         (_G + 8, 2 * _T + 1)]
_WARP = np.arange(8)[:, None]
_R0, _C0 = 16 * (_WARP % 4), 32 * (_WARP // 4)  # (8, 1) each


def _split(v):
    """hi rounded to TF32 to nearest (ties away), lo = v - hi truncated to
    TF32 as the tensor cores read it."""
    bits = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    hi = ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    lo = (v - hi).astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)
    return hi, lo.view(np.float32)


def _rz(v):
    """fp64 -> fp32 rounded toward zero (the tensor cores' accumulation)."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mma3(c, a, b):
    """c (8, 32, 4) += a (8, 32, 4) . b (8, 32, 2) per warp, in split
    TF32: a_lo . b_hi, a_hi . b_lo, a_hi . b_hi, each summed exactly and
    added to the fp32 accumulator with truncation."""

    def mat(f, layout, shape):
        m = np.zeros((8,) + shape)
        for i, (r, k) in enumerate(layout):
            m[_WARP, r, k] = f[..., i]
        return m

    (ah, al), (bh, bl) = _split(a), _split(b)
    cm = mat(c, _C_RC, (16, 8))
    for fa, fb in ((al, bh), (ah, bl), (ah, bh)):
        cm = _rz(cm + mat(fa, _A_RC, (16, 8)) @ mat(fb, _B_KN, (8, 8)))
    return np.stack([cm[_WARP, r, k] for r, k in _C_RC], axis=-1)


def _dot_abt(a, b):
    """The kernel's dot_abt: a, b (64, 64) tiles -> (8, 4, 32, 4), warp
    w's rows r0.. of a against rows c0.. of b."""
    c = np.zeros((8, 4, 32, 4), np.float32)
    for kk in range(8):
        col = kk * 8 + _T
        fa = np.stack([a[_R0 + _G, col], a[_R0 + _G + 8, col],
                       a[_R0 + _G, col + 4], a[_R0 + _G + 8, col + 4]], -1)
        for j in range(4):
            row = _C0 + 8 * j + _G
            fb = np.stack([b[row, col], b[row, col + 4]], -1)
            c[:, j] = _mma3(c[:, j], fa, fb)
    return c


def _acc_pb(c, p, b):
    """The kernel's acc_pb: c (8, 8, 32, 4) += P . B, P a (8, 4, 32, 4)
    score tile, its columns 2t, 2t + 1 of tile j as the A fragment's t,
    t + 4, against rows c0.. of b."""
    for j in range(4):
        fa = p[:, j][..., [0, 2, 1, 3]]
        row = _C0 + 8 * j + 2 * _T
        for n in range(8):
            fb = np.stack([b[row, 8 * n + _G], b[row + 1, 8 * n + _G]], -1)
            c[:, n] = _mma3(c[:, n], fa, fb)
    return c


def _c_layout(nt, col0):
    """Row and column of each element of a warp's C-layout tile of nt
    column tiles (columns from col0 per warp): (8, nt, 32, 4) each."""
    r = _R0[:, :, None, None] + np.stack([_G, _G, _G + 8, _G + 8], -1)
    c = (col0[:, :, None, None] + 8 * np.arange(nt)[None, :, None, None]
         + np.stack([2 * _T, 2 * _T + 1, 2 * _T, 2 * _T + 1], -1))
    shape = (8, nt, 32, 4)
    return np.broadcast_to(r, shape), np.broadcast_to(c, shape)


def _halves(c):
    """A block's (64, 64) output: each row group's two halves (warps w and
    w + 4) added, round to nearest."""
    out = np.zeros((64, 64), np.float32)
    r, k = _c_layout(8, 0 * _C0)
    total = (c[:4] + c[4:]).astype(np.float32)
    out[r[:4], k[:4]] = total
    return out


def _b7_fp32_emulated(q, k, v, o, do, lse, vl, scale):
    """One head: (T, 64) fp32 q, k, v, O, dO and lse (T,) -> dq, dk, dv as
    the two passes compute them, tile by tile."""
    t = q.shape[0]
    n_t = -(-t // 64)

    def tile(x, i):
        out = np.zeros((64, 64), np.float32)
        rows = x[64 * i:64 * i + 64]
        out[:len(rows)] = rows
        return out

    def pad(x, i, fill):
        out = np.full(64, fill, np.float32)
        rows = x[64 * i:64 * i + 64]
        out[:len(rows)] = rows
        return out

    dr = (do * o).sum(-1, dtype=np.float32)
    rows, cols = _c_layout(4, _C0)
    sc = np.float32(scale)
    dq, dk, dv = (np.zeros((n_t * 64, 64), np.float32) for _ in range(3))
    for qi in range(n_t):  # pass 1
        l, d = pad(lse, qi, np.inf)[rows], pad(dr, qi, 0.0)[rows]
        acc = np.zeros((8, 8, 32, 4), np.float32)
        for ki in range(-(-vl // 64)):
            s = _dot_abt(tile(q, qi), tile(k, ki))
            dp = _dot_abt(tile(do, qi), tile(v, ki))
            pn = np.where(64 * ki + cols < vl, np.exp(s * sc - l), 0)
            acc = _acc_pb(acc, (pn * (dp - d)).astype(np.float32),
                          tile(k, ki))
        dq[64 * qi:64 * qi + 64] = _halves(acc) * sc
    for ki in range(n_t):  # pass 2
        key_in = 64 * ki + rows < vl
        a_k, a_v = (np.zeros((8, 8, 32, 4), np.float32) for _ in range(2))
        for qi in range(n_t):
            s = _dot_abt(tile(k, ki), tile(q, qi))
            dp = _dot_abt(tile(v, ki), tile(do, qi))
            pn = np.where(key_in, np.exp(s * sc - pad(lse, qi, np.inf)[cols]),
                          0).astype(np.float32)
            a_v = _acc_pb(a_v, pn, tile(do, qi))
            a_k = _acc_pb(a_k, (pn * (dp - pad(dr, qi, 0.0)[cols])).astype(
                np.float32), tile(q, qi))
        dk[64 * ki:64 * ki + 64] = _halves(a_k) * sc
        dv[64 * ki:64 * ki + 64] = _halves(a_v)
    return dq[:t], dk[:t], dv[:t]


def test_b7_fp32_kernel_arithmetic_emulated():
    """The fp32 B7 kernel's fragment indices, the C-layout score tile fed
    to the products over its columns, the masking and the statistics
    (emulated on the CPU, split TF32 in the kernel's order) agree with
    the plain twin within the card's gate, 1e-4 of max|plain| for each of
    dq, dk and dv, on two query and key tiles with a ragged edge and
    valid_len 100; the keys at or past valid_len get no gradient."""
    qkv, do = _inputs(5, n=1, t=130, heads=2)
    vl = 100
    q_t, d_t = torch.from_numpy(qkv), torch.from_numpy(do)
    o_t, lse = flash_attention_flat_plain(q_t, 2, SCALE, vl, return_lse=True)
    ref = flash_attention_flat_bwd_plain(q_t, o_t, d_t, lse, 2, SCALE,
                                         vl).numpy()[0]
    o, lse = o_t.numpy()[0], lse.numpy()[0]
    for h in range(2):
        cols = slice(64 * h, 64 * h + 64)
        q, k, v = (qkv[0, :, 128 * i:128 * i + 128][:, cols]
                   for i in range(3))
        got = _b7_fp32_emulated(q, k, v, o[:, cols], do[0][:, cols],
                                lse[h], vl, SCALE)
        for i, g_ in enumerate(got):
            want = ref[:, 128 * i:128 * i + 128][:, cols]
            err = np.abs(g_ - want).max()
            assert err <= FP32_BWD_REL * np.abs(want).max(), (h, i, err)
        assert not got[1][vl:].any() and not got[2][vl:].any()


# B6's fp32 mode (csrc/flash_attention_flat_fp32.cu) emulated on the CPU
# a 64 x 64 tile at a time: per k-step of 8 the split-TF32 products
# a_lo . b_hi, a_hi . b_lo, a_hi . b_hi (`terms` = 1: a_hi . b_hi alone,
# one TF32 product), each summed exactly and added to the fp32
# accumulator with truncation; S afresh per key tile; the online softmax
# in the base-2 domain (scores times scale * log2 e, P = 2^(x - m) rounded
# once to fp32: ex2.approx's ~2 ulp are far below the gate); O rescaled
# by alpha with a round-to-nearest multiply, then P . V added in place.
def _tf32_products(c, a, b, terms=3):
    (ah, al), (bh, bl) = _split(a), _split(b)
    pairs = ((al, bh), (ah, bl), (ah, bh))[3 - terms:]
    for k in range(0, a.shape[1], 8):
        for fa, fb in pairs:
            c = _rz(c + fa[:, k:k + 8].astype(np.float64)
                    @ fb[k:k + 8].astype(np.float64))
    return c


def _b6_fp32_emulated(q, k, v, vl, scale, terms=3):
    """One head: (T, 64) fp32 q, k, v -> O (T, 64) and lse (T,)."""
    t = q.shape[0]

    def tile(x, i):
        out = np.zeros((64, 64), np.float32)
        rows = x[64 * i:64 * i + 64]
        out[:len(rows)] = rows
        return out

    sc = np.float32(scale) * np.float32(np.log2(np.e))
    o_all, lse_all = [], []
    for qi in range(-(-t // 64)):
        m = np.full(64, -np.inf, np.float32)
        l = np.zeros(64, np.float32)
        o = np.zeros((64, 64), np.float32)
        for ki in range(-(-vl // 64)):
            s = _tf32_products(np.zeros((64, 64), np.float32), tile(q, qi),
                               tile(k, ki).T.copy(), terms)
            x = np.where(64 * ki + np.arange(64) < vl, s * sc,
                         -np.inf).astype(np.float32)
            m_new = np.maximum(m, x.max(1))
            p = np.exp2(x - m_new[:, None]).astype(np.float32)
            alpha = np.exp2(m - m_new).astype(np.float32)
            l = l * alpha + p.sum(1, dtype=np.float32)
            o = _tf32_products(o * alpha[:, None], p, tile(v, ki), terms)
            m = m_new
        o_all.append(o / l[:, None])
        lse_all.append((m + np.log2(l)) * np.float32(np.log(2.0)))
    return np.concatenate(o_all)[:t], np.concatenate(lse_all)[:t]


@pytest.mark.parametrize("t,valid_len", [(40, None), (130, 100)])
def test_b6_fp32_kernel_arithmetic_emulated(t, valid_len):
    """The fp32 B6 kernel's arithmetic (split TF32 in the kernel's term
    order, truncating sums per k-step, the base-2 online softmax with O
    rescaled in place) agrees with the plain twin within the card's
    gates, O within 2e-5 + 1e-4 |plain| and lse within 1e-5, on one and
    on three query tiles with a ragged edge and valid_len 100; one TF32
    product instead of the split misses them."""
    qkv, _ = _inputs(6, n=1, t=t, heads=2)
    vl = valid_len or t
    ref_o, ref_lse = flash_attention_flat_plain(
        torch.from_numpy(qkv), 2, SCALE, valid_len, return_lse=True)
    for terms in (3, 1):
        within = True
        for h in range(2):
            cols = slice(64 * h, 64 * h + 64)
            q, k, v = (qkv[0, :, 128 * i:128 * i + 128][:, cols]
                       for i in range(3))
            o, lse = _b6_fp32_emulated(q, k, v, vl, SCALE, terms)
            want = ref_o[0][:, cols].numpy()
            within &= bool(
                (np.abs(o - want) <= FP32_ATOL + FP32_RTOL * np.abs(want)
                 ).all()
                and (np.abs(lse - ref_lse[0, h].numpy()) <= FP32_LSE_ATOL
                     ).all())
        assert within == (terms == 3), terms


def _fp32_train_step(cfg, dev, plain):
    """One fp32 train step (`make_train_step`, the `--dtype float32`
    CLI's step) of `cfg` from seed 0 on a 64 x 64 synthetic batch of 2;
    returns (model, loss, launches of B6 and B7)."""
    from lseg_tpu_torch.data.loader import DataLoader
    from lseg_tpu_torch.data.synthetic import SyntheticSegDataset
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.train.optim import make_optimizer
    from lseg_tpu_torch.train.step import (
        TrainState,
        enable_grads,
        make_train_step,
    )

    model = LSegNet(cfg, torch.float32, dev, plain=plain, remat=True,
                    param_dtype=torch.float32)
    random_init_(model, torch.Generator(dev).manual_seed(0))
    enable_grads(model)
    ds = SyntheticSegDataset(n=2, size=64, num_classes=4)
    batch = next(iter(DataLoader(ds, 2, shuffle=False, device=dev)))
    txt = torch.randn(4, cfg.out_c, generator=torch.Generator().manual_seed(
        1)).to(dev)
    state = TrainState(model, make_optimizer(model, 0.004, 10, batch_size=2))
    f0, b0 = flash_attention_flat.launches, flash_attention_flat_bwd.launches
    _, metrics = make_train_step()(state, batch, txt)
    torch.cuda.synchronize()
    return model, float(metrics["loss"]), (
        flash_attention_flat.launches - f0,
        flash_attention_flat_bwd.launches - b0)


@pytest.mark.gpu
def test_fp32_train_step_runs_the_fp32_kernels(cuda_device):
    """One `--dtype float32` train step of the tiny flashflat config on
    the card goes through B6's and B7's fp32 modes (B6 twice a block with
    remat, B7 once) and its ViT gradients agree with the plain path's
    within 1e-4 (global relative norm): fp32 on both sides."""
    from torch_parity import tiny_parity_config

    base = tiny_parity_config()
    cfg = dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, attn_impl="flashflat"))
    depth = cfg.vit.depth
    kern, loss_k, launched = _fp32_train_step(cfg, cuda_device, False)
    assert launched == (2 * depth, depth)
    ref, loss_p, launched = _fp32_train_step(cfg, cuda_device, True)
    assert launched == (0, 0)
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)
    num = den = 0.0
    for name, p in kern.vit.named_parameters():
        gr = ref.vit.get_parameter(name).grad
        num += float(((p.grad - gr) ** 2).sum())
        den += float((gr ** 2).sum())
    assert (num / den) ** 0.5 <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["flashq", "flashqp", "flashlnq"])
def test_fp32_unquantized_flash_impls_take_fp32_b6(cuda_device, impl):
    """An fp32 model whose attn_impl is flashq, flashqp or flashlnq but
    which is not quantized takes the flat branch, as the reference does:
    B6's fp32 mode, once a block, in an eval forward."""
    from torch_parity import tiny_parity_config

    from lseg_tpu_torch.models.layers import random_init_

    base = tiny_parity_config()
    cfg = dataclasses.replace(base.vit, attn_impl=impl)
    vit = DenseViT(cfg, torch.float32, device=cuda_device)
    random_init_(vit, torch.Generator(cuda_device).manual_seed(0))
    x = torch.randn(1, 64, 64, 3, device=cuda_device)
    f0 = flash_attention_flat.launches
    with torch.no_grad():
        taps, _ = vit(x)
        plain = DenseViT(cfg, torch.float32, plain=True, device=cuda_device)
        plain.load_state_dict(vit.state_dict())
        ref, _ = plain(x)
    torch.cuda.synchronize()
    assert flash_attention_flat.launches - f0 == cfg.depth
    for a, b in zip(taps, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
