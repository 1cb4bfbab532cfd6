"""The two remaining fused head forms against the JAX package's: the plain
twins of kernels B14 (`head1_correlate_wup_fused`) and B13
(`head1_correlate_upsample_argmax`) against the Pallas kernels in
interpret mode, the `head_fused='wup'` model's full-resolution logits and
its routing of the other calls, and the `gpu`-marked checks of both CUDA
kernels against their plain versions. The flax models of the JAX package
are imported inside the fixture that uses them: the card machine has JAX
but no flax."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    assert_bf16_bound,
    cuda_device,
    f32,
    fp32_reference_of,
    inputs,
    jax_lseg_variables,
    tiny_parity_config,
)

from lseg_tpu.config import fast_serving
from lseg_tpu.ops.pallas_correlation import (
    head1_correlate_upsample_argmax as j_b13,
)
from lseg_tpu.ops.pallas_correlation import (
    head1_correlate_wup_fused as j_b14,
)
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.ops.head1_correlate import (
    B13_STRIP,
    HEAD_KG,
    b13_grid,
    b14_ctas,
    head1_correlate_fused,
    head1_correlate_fused_plain,
    head1_correlate_upsample_argmax,
    head1_correlate_upsample_argmax_plain,
    head1_correlate_wup_fused,
    head1_correlate_wup_fused_plain,
    upsample_argmax_bf16,
    w_interp_bf16,
)
from lseg_tpu_torch.utils.convert import from_jax_variables


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes(seed, n, h, w, c, e, k, neg=False):
    """Seeded head inputs as the reference's tests make them, in both
    layouts: (jax args, port args). `neg` makes every logit negative
    (positive text rows, embeddings pushed below zero by the bias)."""
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (n, h, w, c)).astype(np.int8)
    w1q = rng.randint(-127, 128, (c, e)).astype(np.int8)     # JAX (C, E)
    s1 = (rng.rand(e) * 0.01 + 1e-3).astype(np.float32)
    b1 = (rng.randn(e) * 0.1).astype(np.float32)
    txt = rng.randn(k, e).astype(np.float32)
    if neg:
        s1 = (rng.rand(e) * 1e-4 + 1e-5).astype(np.float32)
        b1 = -(rng.rand(e) + 1.0).astype(np.float32)
        txt = (rng.rand(k, e) + 0.1).astype(np.float32)
    sx = np.float32(0.02)
    jargs = (jnp.asarray(xq), jnp.asarray(sx),
             jnp.asarray(w1q.reshape(1, 1, c, e)), jnp.asarray(s1),
             jnp.asarray(b1), jnp.asarray(txt))
    targs = (_t(xq), torch.tensor(sx), _t(np.ascontiguousarray(w1q.T)),
             _t(s1), _t(b1), _t(txt))
    return jargs, targs


# ---- B14: head1 + normalized correlation + x2 W-interp ----

@pytest.mark.parametrize("n,h,w,c,e,k", [(2, 8, 16, 32, 64, 7),
                                         (1, 4, 9, 64, 128, 5)])
def test_head1_correlate_wup_plain_matches_pallas(n, h, w, c, e, k):
    """At the sizes of the reference's own check
    (tests/test_correlation_parity.py:97-115) and an odd width: bf16
    within rtol/atol 1e-2, K unpadded."""
    jargs, targs = _codes(0, n, h, w, c, e, k)
    ref = f32(j_b14(*jargs, rows=4, interpret=True))
    got = head1_correlate_wup_fused_plain(*targs)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape == (
        n, h, 2 * w, k)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-2,
                               atol=1e-2)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        head1_correlate_wup_fused(*targs).float().numpy(),
        got.float().numpy())


def test_head1_correlate_wup_plain_is_w_interp_of_b4():
    """The W-interp of B4's normalized logits, two taps per output column:
    the even columns of an align-corners x2 interp of W = 2 are the
    source columns, and every output lies between its two taps."""
    _, targs = _codes(1, 1, 3, 2, 32, 128, 6)
    lo = head1_correlate_fused_plain(*targs).float()
    up = head1_correlate_wup_fused_plain(*targs).float()
    np.testing.assert_array_equal(up[:, :, 0].numpy(), lo[:, :, 0].numpy())
    np.testing.assert_array_equal(up[:, :, 3].numpy(), lo[:, :, 1].numpy())
    lo_min = torch.minimum(lo[:, :, 0], lo[:, :, 1])
    lo_max = torch.maximum(lo[:, :, 0], lo[:, :, 1])
    for j in (1, 2):
        assert bool((up[:, :, j] >= lo_min).all() and
                    (up[:, :, j] <= lo_max).all())


# ---- B13: head1 + correlation + x2 upsample + argmax ----

@pytest.mark.parametrize("case", ["reference", "all-negative"])
def test_head1_correlate_upsample_argmax_plain_matches_pallas(case):
    """At the sizes of the reference's own check
    (tests/test_correlation_parity.py:67-81), and with every logit
    negative and K = 13, not a multiple of 8, so that no padded label can
    win: >= 0.999 of the labels equal (the same bf16 operands, fp32 sums
    in another order, so a label may flip at an fp32 tie)."""
    neg = case == "all-negative"
    shape = (2, 16, 16, 32, 64, 13 if neg else 7)
    jargs, targs = _codes(2, *shape, neg=neg)
    if neg:
        lo = head1_correlate_fused_plain(*targs)
        assert bool((lo < 0).all())
    ref = np.asarray(j_b13(*jargs, rows=4, interpret=True))
    got = head1_correlate_upsample_argmax_plain(*targs)
    assert got.dtype == torch.int32 and got.shape == ref.shape == (2, 32, 32)
    agree = float(np.mean(got.numpy() == ref))
    assert agree >= 0.999, agree
    assert 0 <= int(got.min()) and int(got.max()) < shape[-1]
    np.testing.assert_array_equal(
        head1_correlate_upsample_argmax(*targs).numpy(), got.numpy())


@pytest.mark.parametrize("shape", [(1, 1, 5, 32, 128, 4),
                                   (1, 3, 1, 32, 128, 4)])
def test_head1_correlate_upsample_argmax_plain_edges(shape):
    """One source row or one source column (the x2 operator of a size-1
    axis copies it) against the Pallas kernel with one band per source
    row; first index on ties."""
    jargs, targs = _codes(3, *shape)
    got = head1_correlate_upsample_argmax_plain(*targs)
    ref = np.asarray(j_b13(*jargs, rows=1, interpret=True))
    assert got.shape == ref.shape == (1, 2 * shape[1], 2 * shape[2])
    np.testing.assert_array_equal(got.numpy(), ref)


def test_head1_correlate_upsample_argmax_plain_ties():
    """A text matrix with two equal rows ties everywhere: the first
    wins."""
    _, (xq, sx, w, s1, b1, txt) = _codes(4, 1, 4, 4, 32, 128, 3)
    txt = torch.stack([txt[1], txt[0], txt[0]])
    got = head1_correlate_upsample_argmax_plain(xq, sx, w, s1, b1, txt)
    assert not bool((got == 2).any())


def _taps_kernel(o, n):
    """Kernel B13's `taps`: the lower source index of output o of an
    align-corners x2 interp over n, and its fp32 weights, from the float64
    source position."""
    if n == 1:
        return 0, np.float32(1.0), np.float32(0.0)
    src = o * (n - 1) / (2 * n - 1)
    lo = min(max(int(math.floor(src)), 0), n - 2)
    return lo, np.float32(1.0 - (src - lo)), np.float32(src - lo)


def _b13_walk_emulated(lo, sms, stale_ring=False, tie_to_later=False):
    """Kernel B13's walk over the labels in chunks of `HEAD_KG`: the walk
    of `_b13_walk_best` once a chunk, each output pixel's running (value,
    label) replaced by a chunk's best only where that is strictly larger
    (with `tie_to_later`, where it is not smaller: a mutation), so that
    ties go to the smaller label as in one pass."""
    k = lo.shape[-1]
    val = lab = None
    for kt0 in range(0, k, HEAD_KG):
        v, i = _b13_walk_best(lo[..., kt0:kt0 + HEAD_KG], sms, stale_ring)
        if val is None:
            val, lab = v, i
            continue
        win = v >= val if tie_to_later else v > val
        val = torch.where(win, v, val)
        lab = torch.where(win, i + kt0, lab)
    return lab


def _b13_walk_best(lo, sms, stale_ring=False):
    """Kernel B13's walk (csrc/head1_correlate_upsample_argmax.cu) in torch
    on the CPU, fed with normalized bf16 logits (N, H, W, K): the grid of
    `b13_grid` (strips of 127 source columns plus the one they share,
    segments of source rows); each CTA walks its segment's rows ra ..
    min(rb, H - 1), keeping the previous row's logits (the ring; with
    `stale_ring` it is never advanced past the segment's first row), and at
    row r emits the output rows whose first H tap is r - 1, and at r =
    H - 1 those whose tap is H - 1 itself; each pixel of the strip emits
    the output columns whose left tap it is, its right neighbour read
    within the strip. Rounding as the kernel's: H-blend, W-interp and the
    first argmax over the K labels, returned with its bf16 value."""
    n, h, w, k = lo.shape
    strips, seg, nseg = b13_grid(n, h, w, sms)
    lof = lo.float()
    out = torch.full((n, 2 * h, 2 * w), -1, dtype=torch.int32)
    best = torch.zeros((n, 2 * h, 2 * w))
    rows = []
    for o in range(2 * h):
        ho_lo, a0, a1 = _taps_kernel(o, h)
        ho = ho_lo if a0 > 0 else ho_lo + 1
        rows.append((ho, np.float32(1.0) - (a0 if a0 > 0 else a1)))
    cols = [_taps_kernel(j, w) for j in range(2 * w)]
    bf = lambda v: float(torch.tensor(v).to(torch.bfloat16))  # noqa: E731
    for s in range(strips):
        c0 = s * B13_STRIP
        own = [j for j, (c, _, _) in enumerate(cols)
               if c0 <= c < c0 + B13_STRIP]
        for g in range(nseg):
            ra, rb = g * seg, min(g * seg + seg, h)
            prev = None
            for r in range(ra, min(rb, h - 1) + 1):
                cur = lof[:, r, c0:c0 + B13_STRIP + 1]
                for o, (ho, f) in enumerate(rows):
                    if not ((r > ra and ho == r - 1)
                            or (r == h - 1 and r < rb and ho == r)):
                        continue
                    p0 = prev if ho == r - 1 else cur
                    fa = np.float32(1.0) - f
                    hb = (p0 * float(fa) + cur * float(f)).to(torch.bfloat16)
                    for j in own:
                        c, a0, a1 = cols[j]
                        p, p1 = c - c0, min(c + 1, w - 1) - c0
                        up = (bf(a0) * hb[:, p].float()
                              + bf(a1) * hb[:, p1].float()).to(torch.bfloat16)
                        out[:, o, j] = torch.argmax(up.float(), dim=-1).to(
                            torch.int32)
                        best[:, o, j] = up.float().amax(dim=-1)
                if prev is None or not stale_ring:
                    prev = cur
    return best, out


@pytest.mark.parametrize("shape,sms", [
    ((1, 6, 240, 32, 128, 150), 132),   # flagship width, segments of 1 row
    ((1, 7, 240, 32, 128, 150), 4),     # segments of 4 and 3 rows
    ((2, 16, 16, 32, 64, 13), 6),       # the reference case, all-negative
    ((1, 1, 5, 32, 128, 4), 132),       # one source row
    ((1, 3, 1, 32, 128, 4), 132),       # one source column
    ((1, 9, 130, 32, 128, 7), 2),       # two strips, the second of 2 columns
])
def test_b13_walk_emulated(shape, sms):
    """Kernel B13's strip and segment walk, fed with
    `head1_correlate_fused_plain`'s normalized logits, equals
    `upsample_argmax_bf16` of the same logits bit for bit: at the flagship
    W = 240 (two strips) with small H, at H not a multiple of the segment,
    at the reference's all-negative case and the one-row and one-column
    edges of `test_head1_correlate_upsample_argmax_plain_edges`. Where a
    segment has more than two rows and the labels vary (not the
    all-negative case, whose label is the same almost everywhere), a ring
    not advanced differs."""
    neg = shape[-1] == 13
    _, targs = _codes(8, *shape, neg=neg)
    lo = head1_correlate_fused_plain(*targs)
    ref = upsample_argmax_bf16(lo)
    got = _b13_walk_emulated(lo, sms)
    assert bool((got >= 0).all())
    assert torch.equal(got, ref)
    if b13_grid(shape[0], shape[1], shape[2], sms)[1] > 2 and not neg:
        assert not torch.equal(_b13_walk_emulated(lo, sms, True), ref)


@pytest.mark.parametrize("k", [153, 171, 300])
def test_b13_label_chunks_emulated(k):
    """Past 152 labels B13 walks once a chunk of 152 and keeps each
    output pixel's running key: equal to `upsample_argmax_bf16` bit for
    bit at K = 153 (a chunk of one label), 171 and 300, on two strips and
    segments of more than two rows. With the later chunks' text a copy of
    the first chunk's, every label of a later chunk ties one of the first:
    a walk whose later chunk wins ties differs."""
    shape, sms = (1, 7, 130, 32, 128, k), 2
    _, targs = _codes(9, *shape)
    lo = head1_correlate_fused_plain(*targs)
    assert torch.equal(_b13_walk_emulated(lo, sms),
                       upsample_argmax_bf16(lo))
    txt = targs[-1].clone()
    txt[HEAD_KG:] = txt[:k - HEAD_KG]
    lo = head1_correlate_fused_plain(*targs[:-1], txt)
    ref = upsample_argmax_bf16(lo)
    assert torch.equal(_b13_walk_emulated(lo, sms), ref)
    assert not torch.equal(_b13_walk_emulated(lo, sms, tie_to_later=True),
                           ref)


# kernel B14's staging (csrc/head1_correlate_wup.cu): output columns a
# warp's pass stages, and a warp's staging area in bytes
_B14_CAP, _B14_REGION = 18, 18 * (2 * HEAD_KG + 16) + 16


def _b14_neighbour(stale=False):
    """The step pixel whose logits kernel B14's thread of consumer warp
    cw (0..7), lane, row half h takes as its pixel's right neighbour: the
    rotated shuffle of lane + 4 (lanes 0..3 offering their second row to
    the first half), the next warp's first pixel from shared memory for
    the last lanes' second half, its own pixel in the last warp. `stale`
    (a mutation) takes the edge of the warp itself."""
    nb = {}
    for cw in range(8):
        for lane in range(32):
            g = lane // 4
            for h in range(2):
                src = (lane + 4) % 32
                sg = src // 4
                if g < 7 or h == 0:
                    nb[cw, lane, h] = 16 * cw + sg + (
                        8 if h == 0 and src < 4 else 8 * h)
                elif cw + 1 < 8:
                    nb[cw, lane, h] = 16 * (cw + 1) if not stale else 16 * cw
                else:
                    nb[cw, lane, h] = 16 * cw + g + 8
    return nb


def _b14_walk_emulated(lo, sms, stale_neighbour=False):
    """Kernel B14's persistent walk and output staging in numpy, fed with
    normalized bf16 logits (N, H, W, K): the grid of `b14_ctas` (a CTA
    keeps one strip of 127 source columns and takes rows row0, row0 + rs,
    ..., once a label chunk of 152); in each step each consumer warp's two
    passes of 8 pixels stage the output columns whose left tap is their
    pixel at a pitch congruent to the output's row pitch mod 16 bytes, then
    copy each contiguous range (the pass's columns with one chunk, a column
    with more) as a 16-byte aligned middle and 2-byte ends. Asserts that
    no staged byte is written twice, that the staging fits its area, that
    the bulk copies are 16-byte aligned on both sides and that every output
    byte is written once; returns the (N, H, 2W, K) bf16 output."""
    n, h, w, k = lo.shape
    rows = n * h
    strips = max(1, -(-(w - 1) // B13_STRIP))
    grid = min(b14_ctas(w, sms), rows * strips)
    rs = grid // strips
    lof = lo.float().reshape(rows, w, k)
    cols = [_taps_kernel(j, w) for j in range(2 * w)]
    bf = lambda v: np.float32(torch.tensor(float(v)).to(  # noqa: E731
        torch.bfloat16).float())
    out = np.zeros(rows * 2 * w * k * 2, np.uint8)
    written = np.zeros(out.shape, np.int32)
    nbr = _b14_neighbour(stale_neighbour)
    for cta in range(grid):
        c0 = (cta % strips) * B13_STRIP
        owns = {}
        for p in range(128):
            c = c0 + p
            js = [j for j, (lo_j, _, _) in enumerate(cols)
                  if p < B13_STRIP and c <= max(w - 2, 0) and lo_j == c]
            owns[p] = (js[0], js[-1]) if js else (0, -1)
        for kt0 in range(0, k, HEAD_KG):
            kc = min(HEAD_KG, k - kt0)
            pitch = 2 * k if kc == k else 2 * kc + (2 * (k - kc)) % 16
            for row in range(cta // strips, rows, rs):
                def pix(q):  # the step's pixel q (TMA: past W, next row)
                    m = row * w + c0 + q
                    if m >= rows * w:
                        return torch.zeros(k)
                    return lof[m // w, m % w]
                for cw in range(8):
                    for hh in range(2):
                        first = 16 * cw + 8 * hh
                        spans = [owns[first + g] for g in range(8)]
                        jp = min([a for a, b in spans if b >= a],
                                 default=None)
                        if jp is None:
                            continue
                        jq = max(b for a, b in spans if b >= a)
                        for r0 in range(jp, jq + 1, _B14_CAP):
                            nr = min(_B14_CAP, jq - r0 + 1)
                            g0 = ((row * 2 * w + r0) * k + kt0) * 2
                            s0 = g0 % 16
                            region = np.zeros(_B14_REGION, np.uint8)
                            seen = np.zeros(_B14_REGION, np.int32)
                            for g in range(8):
                                p = first + g
                                q = nbr[cw, 4 * g, hh] if w > 1 else p
                                a_, b_ = owns[p]
                                for j in range(max(a_, r0),
                                               min(b_, r0 + nr - 1) + 1):
                                    _, a0, a1 = cols[j]
                                    v = (bf(a0) * pix(p)[kt0:kt0 + kc]
                                         + bf(a1) * pix(q)[kt0:kt0 + kc])
                                    raw = v.to(torch.bfloat16).view(
                                        torch.int16).numpy().view(np.uint8)
                                    at = s0 + (j - r0) * pitch
                                    assert at + 2 * kc <= _B14_REGION
                                    region[at:at + 2 * kc] = raw
                                    seen[at:at + 2 * kc] += 1
                            assert seen.max() <= 1
                            ranges = ([(g0, s0, nr * 2 * k)] if kc == k else
                                      [(g0 + i * 2 * k, s0 + i * pitch,
                                        2 * kc) for i in range(nr)])
                            for ga, sa, ln in ranges:
                                head = min((16 - ga % 16) % 16, ln)
                                mid = (ln - head) // 16 * 16
                                if mid:
                                    assert (ga + head) % 16 == 0
                                    assert (sa + head) % 16 == 0
                                out[ga:ga + ln] = region[sa:sa + ln]
                                written[ga:ga + ln] += 1
    assert written.min() == 1 and written.max() == 1
    return torch.from_numpy(out.view(np.int16).copy()).view(
        torch.bfloat16).reshape(n, h, 2 * w, k)


@pytest.mark.parametrize("w", [1, 2, 127, 128, 240, 255])
@pytest.mark.parametrize("k", [150, 153, 300])
def test_b14_walk_emulated(w, k):
    """Kernel B14's persistent strip walk, neighbour hand-off and staged
    range copies, fed with `head1_correlate_fused_plain`'s normalized
    logits, equal `w_interp_bf16` of them bit for bit: at one and two
    source columns, one strip exactly full (W = 128) and one past it, the
    flagship width, two full strips, and one, two and two uneven label
    chunks, on a grid of 6 CTAs (rows shared out unevenly). A hand-off
    that takes a warp's own edge pixel for the next warp's differs."""
    shape, sms = (1, 3, w, 32, 128, k), 6
    _, targs = _codes(10, *shape)
    lo = head1_correlate_fused_plain(*targs)
    ref = w_interp_bf16(lo)
    assert torch.equal(_b14_walk_emulated(lo, sms), ref)
    if w >= 32 and k == 150:
        assert not torch.equal(_b14_walk_emulated(lo, sms, True), ref)


@pytest.mark.parametrize("fn", [head1_correlate_upsample_argmax,
                                head1_correlate_wup_fused])
def test_b13_b14_wrappers_take_300_labels(fn):
    """Neither wrapper refuses K = 300 (on the CPU each takes its plain
    twin, as on the card it launches its kernel, chunk by chunk); the
    output is the plain twin's."""
    _, targs = _codes(11, 1, 4, 6, 32, 128, 300)
    twin = {head1_correlate_upsample_argmax:
            head1_correlate_upsample_argmax_plain,
            head1_correlate_wup_fused: head1_correlate_wup_fused_plain}[fn]
    got = fn(*targs)
    assert got.shape[-1] == (300 if fn is head1_correlate_wup_fused else 12)
    assert torch.equal(got, twin(*targs))


# ---- the head_fused='wup' model ----

@pytest.fixture(scope="module")
def wup_tree():
    """A perturbed tiny head_dim-64 tree quantized and calibrated in JAX
    (static_cal), the `head_fused='wup'` config, and its conversion."""
    from lseg_tpu.models.lseg import LSegNet as JNet
    from lseg_tpu.ops.quant import calibrate_act_scales as j_calibrate
    from lseg_tpu.ops.quant import quantize_tree as j_quantize_tree

    base = tiny_parity_config()
    x, txt = inputs(0, out_c=base.out_c)
    v = jax_lseg_variables(base, x, txt)
    cfg = fast_serving(base, "static_cal")
    vq = dict(v)
    vq["params"] = j_quantize_tree(v["params"], decoder=True, act_scale=True,
                                   mlp_act_scale=bool(cfg.vit.mlp_act_cal))
    vq = j_calibrate(JNet(cfg, dtype=jnp.bfloat16), vq, jnp.asarray(x), None)
    vq = jax.tree_util.tree_map(np.asarray, vq)
    cfg = dataclasses.replace(cfg, head_fused="wup")
    return x, txt, cfg, vq, from_jax_variables(vq)


def _port(cfg, sd):
    model = LSegNet(cfg, dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True)
    return model


def test_wup_model_logits_within_bf16_bound(wup_tree):
    """`model(x, txt)` runs B14 (its plain twin here) and the bf16
    H-interp: its (N, H, W, K) fp32 logits against JAX's, which runs the
    Pallas B14 in interpret mode, by d_port <= 2 d_ref + 0.05, d_ref =
    JAX's 'wup' bf16 model vs its fp32 reference on the same tree."""
    from lseg_tpu.models.lseg import LSegNet as JNet

    x, txt, cfg, vq, sd = wup_tree

    def jax_logits(c, dt):
        return f32(jax.jit(lambda v, x, t: JNet(c, dtype=dt).apply(
            v, x, t))(vq, jnp.asarray(x), jnp.asarray(txt)))

    ref_bf16 = jax_logits(cfg, jnp.bfloat16)
    ref_fp32 = jax_logits(fp32_reference_of(cfg), jnp.float32)
    with torch.no_grad():
        got = _port(cfg, sd)(_t(x), _t(txt))
    assert got.dtype == torch.float32 and got.shape == ref_bf16.shape == (
        2, 64, 96, 5)
    d_port, d_ref = assert_bf16_bound(got.numpy(), ref_bf16, ref_fp32,
                                      "'wup' full-resolution logits")
    print(f"wup: d_port={d_port} d_ref={d_ref}")


def test_wup_model_routes_each_call(wup_tree):
    """Under `head_fused='wup'` the logits call takes B14 and only that;
    `return_argmax` keeps taking B5 and `return_halfres` B4 with the norm,
    as the reference's branches do (lseg_tpu/models/lseg.py:247-278); the
    logits are the bf16 H-interp of B14's output."""
    from lseg_tpu_torch.ops.resize import resize_bilinear

    x, txt, cfg, _, sd = wup_tree
    model = _port(cfg, sd)
    calls = []
    for name in ("_fused_wup_head", "_fused_argmax_head", "_fused_head"):
        fn = getattr(model, name)
        setattr(model, name, (lambda f, n: lambda *a, **k: calls.append(n)
                              or f(*a, **k))(fn, name))
    seen = {}
    hook = model.refinenet1.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("path1", out))
    with torch.no_grad():
        logits = model(_t(x), _t(txt))
        assert calls == ["_fused_wup_head"]
        wup = model._fused_wup_head(seen["path1"], _t(txt))
        model(_t(x), _t(txt), return_argmax=True)
        model(_t(x), _t(txt), return_halfres=True)
    hook.remove()
    assert calls[2:] == ["_fused_argmax_head", "_fused_head"]
    assert wup.shape == (2, 32, 96, 5) and wup.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        logits.numpy(),
        resize_bilinear(wup, 64, 96, align_corners=True,
                        compute_dtype=torch.bfloat16).float().numpy())


def test_wup_b13_labels_track_wup_logits(wup_tree):
    """B13 on the served path1's codes gives the labels of the x2
    upsample of B4's normalized logits; the argmax of the 'wup' model's
    logits (bf16 H-interp after B14's W-interp) rounds in another order,
    so the two agree up to near ties of the random-init logits."""
    x, txt, cfg, _, sd = wup_tree
    model = _port(cfg, sd)
    seen = {}
    hook = model.refinenet1.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("path1", out))
    with torch.no_grad():
        logits = model(_t(x), _t(txt))
    hook.remove()
    h1 = model.head1
    xq, sx = model._head1_codes(seen["path1"])
    labels = head1_correlate_upsample_argmax(
        xq.contiguous(), sx, h1.weight_q, h1.scale, h1.bias, _t(txt),
        cfg.logit_scale)
    assert labels.shape == (2, 64, 96) and labels.dtype == torch.int32
    agree = float((labels == logits.argmax(-1)).float().mean())
    print(f"B13 labels vs argmax of the 'wup' logits {agree:.4f}")
    assert agree >= 0.95, agree


# ---- the CUDA kernels against their plain versions (on the card) ----

@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 60, 240, 256, 512, 150),
                                   (2, 5, 9, 32, 128, 7),
                                   (1, 12, 240, 256, 512, 236),
                                   (1, 7, 240, 256, 512, 300),
                                   (2, 5, 255, 64, 128, 301),
                                   (1, 6, 20, 288, 256, 9)])
def test_head1_correlate_wup_kernel_matches_plain(cuda_device, shape):
    """Against the plain twin: the kernel's logits may sit one bf16 ulp
    from the plain ones (fp32 sums in another order), the W-interp
    carries that ulp of each tap into outputs that can cancel to near
    zero, and each side rounds its blend once more, so the bound is two
    ulps of the interpolated magnitudes (`w_interp_bf16` of |logits|) +
    1e-3. Against the W-interp of kernel B4's logits on the same inputs
    (the same logits): bit for bit. Beside the flagship: K = 236 and 300
    at W = 240 (rows the earlier kernel could not hold in shared memory),
    an odd W of two strips with an odd K of three chunks, and C = 288 (the
    route of `head1_correlate_wup_wide.cu`)."""
    _, targs = _codes(5, *shape)
    args = [a.to(cuda_device) for a in targs]
    before = head1_correlate_wup_fused.launches
    got = head1_correlate_wup_fused(*args)
    ref = head1_correlate_wup_fused_plain(*args)
    lo = head1_correlate_fused(*args)
    torch.cuda.synchronize()
    assert head1_correlate_wup_fused.launches == before + 1
    env = w_interp_bf16(head1_correlate_fused_plain(*args).abs()).float()
    assert bool(((got.float() - ref.float()).abs()
                 <= 2 ** -6 * env + 1e-3).all())
    assert torch.equal(got, w_interp_bf16(lo))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,neg", [((1, 60, 240, 256, 512, 150), False),
                                       ((2, 5, 9, 32, 128, 13), True),
                                       ((1, 1, 3, 32, 128, 4), False),
                                       ((8, 67, 240, 256, 512, 150), False),
                                       ((1, 9, 130, 128, 256, 4), False),
                                       ((1, 3, 1, 32, 128, 13), True),
                                       ((1, 20, 240, 256, 512, 153), False),
                                       ((2, 9, 130, 256, 512, 300), False),
                                       ((1, 5, 17, 32, 128, 300), True)])
def test_head1_correlate_upsample_argmax_kernel_matches_plain(
        cuda_device, shape, neg):
    """>= 0.999 of the labels equal to the plain twin's; all of them equal
    to the plain tail (`upsample_argmax_bf16`) of kernel B4's logits on
    the same inputs, which it rounds op by op. Beside the flagship row
    width: 8 images of 67 rows (segments of 17, the last of 16), two strips
    whose second owns one column, K = 13 and K = 4, one source column, and
    two and three label chunks (K = 153, 300; all-negative at 300)."""
    _, targs = _codes(6, *shape, neg=neg)
    args = [a.to(cuda_device) for a in targs]
    before = head1_correlate_upsample_argmax.launches
    got = head1_correlate_upsample_argmax(*args)
    ref = head1_correlate_upsample_argmax_plain(*args)
    tail = upsample_argmax_bf16(head1_correlate_fused(*args))
    torch.cuda.synchronize()
    assert head1_correlate_upsample_argmax.launches == before + 1
    assert float((got == ref).float().mean()) >= 0.999
    assert torch.equal(got, tail)
