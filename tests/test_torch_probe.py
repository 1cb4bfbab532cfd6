"""The probe path of the port (`python -m lseg_tpu_torch.probe`) against the
JAX package: the plain twins of kernels B17 (`dense_residual`) and B20 (the
kernel of `scripts/mosaic_probe.py`) against the Pallas kernels in
interpret mode, the probe's variant -> scale-shape map against the
reference probe's own, the CLI without a card, B10's bf16 mode through its
wrapper, and the `gpu`-marked checks of the B17, B20 and B10-bf16 kernels
against their plain versions."""

import functools
import importlib.util
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from torch_parity import cuda_device, f32  # noqa: F401

from lseg_tpu.ops.pallas_dense import dense_residual as j_dense_residual
from lseg_tpu_torch import probe
from lseg_tpu_torch.ops import _build
from lseg_tpu_torch.ops.dense import dense_residual, dense_residual_plain
from lseg_tpu_torch.ops.fused_correlate import (
    fused_correlate,
    fused_correlate_plain,
)
from lseg_tpu_torch.ops.scaled_int8 import (
    B20_ROWS,
    B20_SPLIT,
    SCALE_SHAPES,
    SLICE,
    b20_k_ranges,
    int8_matmul_sliced_scale,
    int8_matmul_sliced_scale_plain,
)

REPO = Path(__file__).resolve().parent.parent
BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value


def _t(a):
    return torch.from_numpy(np.array(a))


def _mosaic_probe():
    """The reference probe script as a module (it is no package member)."""
    spec = importlib.util.spec_from_file_location(
        "mosaic_probe", REPO / "scripts" / "mosaic_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- B17: dense_residual ----

def _dense_inputs(seed, m, k, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            (rng.randn(k, n) * 0.1).astype(np.float32),
            rng.randn(n).astype(np.float32),
            rng.randn(m, n).astype(np.float32))


@pytest.mark.parametrize("with_residual", [True, False])
def test_dense_residual_plain_matches_pallas_fp32(with_residual):
    """The reference test's shapes (tests/test_pallas_ops.py), fp32 out:
    fp32 sums of 128 products in another order."""
    x, w, b, r = _dense_inputs(0, 70, 128, 96)
    r = r if with_residual else None
    ref = f32(j_dense_residual(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if r is None else jnp.asarray(r), tile_m=32,
        out_dtype=jnp.float32, interpret=True))
    args = (_t(x), _t(w), _t(b), None if r is None else _t(r))
    got = dense_residual_plain(*args, tile_m=32, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (70, 96)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        dense_residual(*args, out_dtype=torch.float32).numpy(), got.numpy())


def test_dense_residual_plain_matches_pallas_bf16_ragged():
    """bf16 x, w and residual, bf16 out, M = 300 against the TPU row tile
    of 256 (the reference pads M to 512 and slices; the port does not
    pad): the same bf16 operands, fp32 sums in another order, one bf16
    ulp."""
    x, w, b, r = _dense_inputs(1, 300, 256, 96)
    xj, wj, rj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, r))
    ref = j_dense_residual(xj, wj, jnp.asarray(b), rj, tile_m=256,
                           interpret=True)
    assert ref.dtype == jnp.bfloat16 and ref.shape == (300, 96)
    xt, wt, rt = (_t(f32(a)).to(torch.bfloat16) for a in (xj, wj, rj))
    got = dense_residual_plain(xt, wt, _t(b), rt, tile_m=256)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), f32(ref),
                               rtol=BF16_ULP, atol=1e-6)
    # w is cast to x's dtype, as the reference does
    np.testing.assert_array_equal(
        dense_residual_plain(xt, _t(w), _t(b), rt).float().numpy(),
        got.float().numpy())


def test_dense_residual_ignores_tile_m():
    x, w, b, r = (_t(a) for a in _dense_inputs(2, 33, 64, 24))
    outs = [dense_residual(x, w, b, r, tile_m=tm) for tm in (8, 256, 4096)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("case", ["w", "b", "residual", "int_x", "out"])
def test_dense_residual_checks_shapes_and_dtypes(case):
    x, w, b, r = (_t(a) for a in _dense_inputs(3, 8, 32, 16))
    kw = {}
    if case == "w":
        w = w[:-1]
    elif case == "b":
        b = b[:-1]
    elif case == "residual":
        r = r[:, :-1]
    elif case == "int_x":
        x = x.to(torch.int32)
    else:
        kw["out_dtype"] = torch.int8
    err = TypeError if case in ("int_x", "out") else ValueError
    with pytest.raises(err, match="dense_residual"):
        dense_residual(x, w, b, r, **kw)


# ---- B20: the kernel of the reference probe ----

def _b20_inputs(variant, seed=4, n=2, t=24, d=256):
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, (n, t, d)).astype(np.int8)
    w = rng.randint(-128, 128, (d, 128)).astype(np.int8)
    sw = (1e-3 * (rng.rand(*SCALE_SHAPES[variant]) - 0.25)).astype(
        np.float32)
    return x, w, sw


def _pallas_b20(mod, variant, x, w, sw):
    """The reference probe's `kernel` in its own grid and block specs, at
    the test's (N, T, D), in interpret mode."""
    n, t, d = x.shape
    index = (lambda ni: (0, 0)) if sw.ndim == 2 else (lambda ni: (0, 0, 0))
    f = pl.pallas_call(
        functools.partial(mod.kernel, variant=variant),
        grid=(n,),
        in_specs=[pl.BlockSpec((1, t, d), lambda ni: (ni, 0, 0)),
                  pl.BlockSpec((d, 128), lambda ni: (0, 0)),
                  pl.BlockSpec(sw.shape, index)],
        out_specs=pl.BlockSpec((1, t, 128), lambda ni: (ni, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n, t, 128), jnp.bfloat16),
        interpret=True)
    return f32(f(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sw)))


def _tf32(a, nearest=True):
    """fp32 -> TF32: to nearest, ties away from zero, as the kernels round
    hi (finite inputs); or toward zero, as the tensor cores read lo."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + (0x1000 if nearest else 0)) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32)


def _rz(v):
    """fp64 -> fp32 rounded toward zero: the tensor cores' fp32
    accumulation, which truncates."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _tf32_product(x, w, terms, fold):
    """B17 fp32's product as the tensor cores take it: x and w split into
    TF32 hi and lo (`csrc/tf32x3.cuh`); per k-step of 8, the products of
    `terms` (pairs of 'h'/'l' for x and w, in issue order), each summed
    exactly and added to the accumulator with truncation. With `fold`,
    as the kernel: each 32-deep k-chunk starts a fresh partial, folded
    into the running sum with round-to-nearest adds; without, one
    accumulator takes all K / 8 * len(terms) truncating adds."""
    parts = {}
    for name, a in (("x", x), ("w", w)):
        hi = _tf32(a)
        parts[name + "h"] = hi.astype(np.float64)
        parts[name + "l"] = _tf32(a - hi, nearest=False).astype(np.float64)
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    part = acc.copy()
    for k0 in range(0, x.shape[1], 8):
        if fold and k0 % 32 == 0:
            acc, part = (acc + part).astype(np.float32), part * 0
        for xs, ws in terms:
            step = (parts["x" + xs][:, k0:k0 + 8]
                    @ parts["w" + ws][k0:k0 + 8])
            part = _rz(part.astype(np.float64) + step)
    return (acc + part).astype(np.float32)


@pytest.mark.parametrize("terms,fold,passes", [
    (("lh", "hl", "hh"), True, True),    # the kernel: split, small first
    (("hh", "hl", "lh"), True, True),    # large first
    (("lh", "hl", "hh"), False, False),  # the split on one accumulator
    (("hh",), True, False),              # one TF32 product
    (("hl", "hh"), True, False)],        # the split without x_lo . w_hi
    ids=["kernel", "large-first", "one-accumulator", "one-tf32",
         "no-lo-hi"])
def test_split_tf32_emulation_against_the_fp32_gate(terms, fold, passes):
    """B17's fp32 gate (probe.DENSE_FP32_RTOL/ATOL) at K = 4096 on the
    probe's inputs (x ~ randn, w ~ randn K^-1/2, an fp32 residual),
    against the plain version: the kernel's arithmetic (three-product
    split TF32, per-chunk partials folded with round-to-nearest adds)
    stays within it, in either order of its products; one TF32 product,
    the split without one of its small terms, or the split on one
    truncating accumulator fails it. So the gate tells a kernel that
    dropped its lo terms from one that kept them."""
    rng = np.random.RandomState(0)
    m, k, n = 256, 4096, 128
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) * k ** -0.5).astype(np.float32)
    b = (0.1 * rng.randn(n)).astype(np.float32)
    r = rng.randn(m, n).astype(np.float32)
    got = (_tf32_product(x, w, terms, fold) + b) + r  # the epilogue
    ref = dense_residual_plain(_t(x), _t(w), _t(b), _t(r),
                               out_dtype=torch.float32).numpy()
    bad = np.abs(got - ref) > (probe.DENSE_FP32_ATOL
                               + probe.DENSE_FP32_RTOL * np.abs(ref))
    assert (not bad.any()) == passes, int(bad.sum())


@pytest.mark.parametrize("variant", list(SCALE_SHAPES))
def test_int8_sliced_scale_plain_matches_pallas(variant):
    """Equal by value (Python's `sum` may turn -0.0 into +0.0; numpy's
    equality takes -0.0 == +0.0). No allowance for an FMA contraction by
    XLA on the CPU is needed: none showed here, in sixteen seeded draws at
    D = 1024 either."""
    x, w, sw = _b20_inputs(variant)
    ref = _pallas_b20(_mosaic_probe(), variant, x, w, sw)
    got = int8_matmul_sliced_scale_plain(_t(x), _t(w), _t(sw))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 24, 128)
    got = got.float().numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        int8_matmul_sliced_scale(_t(x), _t(w), _t(sw)).float().numpy(), got)


@pytest.mark.parametrize("variant", list(SCALE_SHAPES))
def test_probe_scale_shapes_match_the_reference_probe(variant, monkeypatch,
                                                      capsys):
    """The reference's `main(variant)` builds its pallas_call with the
    scale block of `SCALE_SHAPES[variant]` (captured here, the call turned
    to interpret mode so it compiles on the CPU) and reports OK."""
    mod = _mosaic_probe()
    seen = {}

    def capture(kernel, **kw):
        seen["block"] = tuple(kw["in_specs"][2].block_shape)
        call = pl.pallas_call(kernel, **kw, interpret=True)

        def traced(x, w, sw):
            seen["array"] = tuple(sw.shape)
            return call(x, w, sw)
        return traced

    monkeypatch.setattr(mod, "pl", types.SimpleNamespace(
        pallas_call=capture, BlockSpec=pl.BlockSpec))
    mod.main(variant)
    assert seen == {"block": SCALE_SHAPES[variant],
                    "array": SCALE_SHAPES[variant]}
    assert f"{variant}: OK" in capsys.readouterr().out
    assert probe.KERNELS[variant] == "int8_matmul_sliced_scale"


def _b20_emulate(x, w, sw, drop=None):
    """The kernel's cut in numpy: tiles of B20_ROWS rows (zeros past M),
    K split over the cluster's CTAs by `b20_k_ranges`, each CTA's int32
    partial of the tile summed (leaving out rank `drop`), then the `_rn`
    epilogue in fp32, ((0 + acc s0) + acc s1) + acc s2, rounded to bf16."""
    m, k = x.shape
    xi, wi = x.astype(np.int64), w.astype(np.int64)
    acc = np.zeros((m, SLICE), np.int64)
    for m0 in range(0, m, B20_ROWS):
        tile = np.zeros((B20_ROWS, k), np.int64)
        tile[:min(B20_ROWS, m - m0)] = xi[m0:m0 + B20_ROWS]
        parts = [tile[:, k0:k1] @ wi[k0:k1] for k0, k1 in b20_k_ranges(k)]
        total = sum(p for r, p in enumerate(parts) if r != drop)
        acc[m0:m0 + B20_ROWS] = total[:min(B20_ROWS, m - m0)]
    assert (np.abs(acc) < 2 ** 31).all()
    a = acc.astype(np.int32).astype(np.float32)
    s = sw.reshape(3, SLICE).astype(np.float32)
    v = (np.float32(0) + a * s[0]) + a * s[1]
    v = v + a * s[2]
    return torch.from_numpy(v).to(torch.bfloat16)


@pytest.mark.parametrize("m,k", [(1808, 1024), (1001, 1024), (1808, 64),
                                 (77, 256), (130, 192)])
def test_b20_split_k_emulated(m, k):
    """Four int32 K-partials a tile, summed, then the `_rn` epilogue: the
    plain twin bit for bit (by value), at the reference's M = 2 x 904,
    M not a multiple of 64 and K = 64 (two ranks with no k-steps), 192,
    256 and 1024."""
    rng = np.random.RandomState(8)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-128, 128, (k, SLICE)).astype(np.int8)
    sw = (1e-3 * (rng.rand(3, SLICE) - 0.25)).astype(np.float32)
    ranges = b20_k_ranges(k)
    assert len(ranges) == B20_SPLIT and ranges[0][0] == 0
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
    assert ranges[-1][1] == k and all(k1 - k0 <= 256 for k0, k1 in ranges)
    ref = int8_matmul_sliced_scale_plain(_t(x)[None], _t(w), _t(sw))[0]
    got = _b20_emulate(x, w, sw)
    assert torch.equal(got.float(), ref.float())
    # a dropped peer's partial shows wherever that peer had k-steps
    for rank, (k0, k1) in enumerate(ranges):
        if k1 > k0:
            dropped = _b20_emulate(x, w, sw, drop=rank)
            assert not torch.equal(dropped.float(), ref.float())


def test_b20_cut_matches_the_kernel_source():
    """B20_ROWS and B20_SPLIT are the tile and cluster size that
    csrc/int8_sliced_scale.cu compiles, and its K split is
    `b20_k_ranges`'."""
    src = (_build.CSRC / probe.B20_SOURCE).read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (BM|SPLIT|MAX_BOXES) = (\d+);", src)}
    assert (consts["BM"], consts["SPLIT"]) == (B20_ROWS, B20_SPLIT)
    assert consts["MAX_BOXES"] * 128 == 1024 // B20_SPLIT
    assert "const int per = (steps + SPLIT - 1) / SPLIT;" in src
    assert "const int s0 = min(rank * per, steps), s1 = min(s0 + per, " \
           "steps);" in src


def test_int8_sliced_scale_checks_shapes():
    x, w, sw = (_t(a) for a in _b20_inputs("rows"))
    with pytest.raises(ValueError, match="scales"):
        int8_matmul_sliced_scale(x, w, sw.reshape(384))
    with pytest.raises(ValueError, match="expected"):
        int8_matmul_sliced_scale(x, w[:, :64], sw)
    with pytest.raises(TypeError, match="x must be"):
        int8_matmul_sliced_scale(x.float(), w, sw)


# ---- B10: compute_dtype = bfloat16 through the wrapper ----

def test_fused_correlate_bf16_mode_wrapper_on_cpu():
    """The wrapper takes the plain version for a CPU tensor in the bf16
    mode too: bf16 logits, equal to the twin's."""
    rng = np.random.RandomState(5)
    x = _t(rng.randn(1, 4, 6, 64).astype(np.float32)).to(torch.bfloat16)
    txt = _t(rng.randn(5, 64).astype(np.float32))
    got = fused_correlate(x, txt, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 4, 6, 5)
    assert torch.equal(got, fused_correlate_plain(
        x, txt, compute_dtype=torch.bfloat16))


# ---- the CLI and the build without a card ----

def test_probe_help_lists_every_case(capsys):
    with pytest.raises(SystemExit) as e:
        probe.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--sources" in out and all(c in out for c in probe.CASES)
    assert probe.CASES == ("sliced", "rows", "rows1d", "bcast", "dense",
                           "ln_qkv")


@pytest.mark.parametrize("argv", [[c] for c in probe.CASES]
                         + [["--sources"], ["--sources", "dense_residual"]])
def test_probe_needs_a_card(argv, monkeypatch, capsys):
    """Without a card every case exits non-zero, naming the device, and
    prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main(argv) == 1
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and "OK" not in out.out


def test_probe_takes_one_case_or_sources():
    for argv in ([], ["dense", "--sources"]):
        with pytest.raises(SystemExit) as e:
            probe.main(argv)
        assert e.value.code == 2


def test_compile_source_without_nvcc_raises(monkeypatch, tmp_path):
    """The probe's one-source build shares the port's compile step: no
    nvcc, no fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.compile_source(_build.CSRC / probe.B20_SOURCE)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_source.__wrapped__(probe.B20_SOURCE)
    with pytest.raises(ValueError, match="no CUDA source"):
        _build.load_source.__wrapped__("lseg_common.cuh")


def test_probe_sources_counts_a_missing_source(capsys):
    assert probe.probe_sources(["no_such_kernel"]) == 1
    assert "no_such_kernel.cu: FAIL" in capsys.readouterr().out


def test_every_kernel_source_has_its_entry_point():
    """Each `csrc/*.cu` defines one C entry point, the one `SIGNATURES`
    binds for it, so that a source compiled alone (`load_source`) exposes
    its kernel."""
    entries = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        names = re.findall(r'extern "C" int (\w+)\(', src.read_text())
        assert len(names) == 1, (src.name, names)
        entries[names[0]] = src.name
    assert sorted(entries) == sorted(_build.SIGNATURES)
    assert entries["lseg_int8_sliced_scale"] == probe.B20_SOURCE


@pytest.mark.parametrize("mangled,name", [
    ("_ZN4lseg12_GLOBAL__N_110flash_flat17flash_flat_kernelE14CUtensorMap_st"
     "P13__nv_bfloat16Pfiiif", "flash_flat_kernel"),
    ("_ZN57_GLOBAL__N__e1f411_17_dense_residual_cu_a199624f18dense_wgmma_"
     "kernelE14CUtensorMap_stS0_", "dense_wgmma_kernel"),
    ("_ZN60_GLOBAL__N__ab12_19_fused_correlate_cu_7f22fused_correlate_kernel"
     "I13__nv_bfloat16EEv14CUtensorMap_st", "fused_correlate_kernelI13__nv_"
     "bfloat16E")])
def test_kernel_names_from_mangled_entry_points(mangled, name):
    """ptxas_summary and chip_smoke.py's SASS check key kernels by the last
    length-prefixed `..._kernel` of the mangled name: an anonymous
    namespace's file tag may itself end in `_kernel`."""
    assert _build._kernel_name(mangled) == name


# ---- the CUDA kernels against their plain versions (on the card) ----

def _close(got, ref, rtol, atol, magnitude=None):
    """|got - ref| <= atol + rtol * magnitude (default |ref|) everywhere."""
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    d = (got.float() - ref.float()).abs()
    mag = ref.float().abs() if magnitude is None else magnitude
    assert bool((d <= atol + rtol * mag).all()), float(d.max())


# fp32 x on the split-TF32 kernel: ragged M (70, 7208), K = 144 (not a
# multiple of its 32-deep k-chunk), N of 8, 96 and 1000 (ragged against
# its 256 columns), each without a residual, with an fp32 residual and
# with an fp32 residual and bf16 output; and a bf16 residual
_FP32_CASES = [
    ((m, 144, n), torch.float32, resid, out)
    for m in (70, 7208) for n in (8, 96, 1000)
    for resid, out in ((None, torch.float32),
                       (torch.float32, torch.float32),
                       (torch.float32, torch.bfloat16))
] + [((7208, 144, 1000), torch.float32, torch.bfloat16, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,residual,out_dtype", [
    ((1802, 4096, 1024), torch.bfloat16, torch.bfloat16, torch.bfloat16),
    ((1802, 1024, 1024), torch.bfloat16, None, torch.bfloat16),
    ((7208, 4096, 1024), torch.bfloat16, torch.bfloat16, torch.bfloat16),
    ((333, 1040, 264), torch.bfloat16, torch.float32, torch.bfloat16),
    ((7208, 4096, 1024), torch.float32, torch.float32, torch.float32),
    ((70, 128, 96), torch.float32, torch.float32, torch.float32),
    ((70, 128, 96), torch.float32, None, torch.float32),
    *_FP32_CASES])
def test_dense_residual_kernel_matches_plain(cuda_device, shape, dtype,
                                             residual, out_dtype):
    """The fp32 gate for fp32 outputs; a bf16 output (of either x dtype)
    may round one bf16 ulp apart, the bf16 gate."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    args = probe.dense_inputs(cuda_device, g, *shape, dtype=dtype,
                              residual=residual)
    before = dense_residual.launches
    got = dense_residual(*args, out_dtype=out_dtype)
    assert dense_residual.launches == before + 1
    rtol, atol = ((probe.DENSE_RTOL, probe.DENSE_ATOL)
                  if out_dtype == torch.bfloat16 else
                  (probe.DENSE_FP32_RTOL, probe.DENSE_FP32_ATOL))
    _close(got, dense_residual_plain(*args, out_dtype=out_dtype), rtol, atol)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(SCALE_SHAPES))
def test_int8_sliced_scale_kernel_matches_plain(cuda_device, variant):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    args = probe.b20_inputs(variant, cuda_device, g)
    _close(int8_matmul_sliced_scale(*args),
           int8_matmul_sliced_scale_plain(*args), 0.0, 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,d", [(2, 904, 1024), (1, 1001, 1024),
                                   (2, 904, 64), (2, 904, 256),
                                   (1, 77, 192), (1, 1, 1024)])
def test_int8_sliced_scale_kernel_shapes(cuda_device, n, t, d):
    """B20 bit for bit at M = 1808, M not a multiple of its 64-row tile,
    K = 64 (two ranks of the cluster without k-steps), 192, 256, 1024."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    args = probe.b20_inputs("rows", cuda_device, g, n=n, t=t, d=d)
    before = int8_matmul_sliced_scale.launches
    got = int8_matmul_sliced_scale(*args)
    assert int8_matmul_sliced_scale.launches == before + 1
    _close(got, int8_matmul_sliced_scale_plain(*args), 0.0, 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,k,dt", [
    ((2, 240, 240, 512), 150, torch.bfloat16),
    ((1, 7, 9, 64), 21, torch.float32),
    ((8, 240, 240, 512), 150, torch.bfloat16),
    ((1, 13, 11, 512), 150, torch.bfloat16),
    ((1, 13, 11, 512), 1, torch.bfloat16),
    ((1, 13, 11, 64), 160, torch.bfloat16)])
def test_fused_correlate_bf16_kernel_matches_plain(cuda_device, shape, k,
                                                   dt):
    """bf16 logits within 1e-3 plus one bf16 ulp (2^-7) of |plain| + scale *
    max|xn| * max|tn|: fp32 sums in another order and one rounding to
    bf16, and one normalised operand that may round to bf16 one ulp apart
    where the kernel's fp32 norm and the twin's differ in the last bit."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(shape, device=cuda_device, generator=g).to(dt)
    t = torch.randn(k, shape[-1], device=cuda_device, generator=g)
    if k > 1:
        t[0] = 0.0
    scale = 1.0 / 0.07
    got = fused_correlate(x, t, compute_dtype=torch.bfloat16)
    ref = fused_correlate_plain(x, t, compute_dtype=torch.bfloat16)
    xm = torch.nn.functional.normalize(x.float(), dim=-1).abs().amax(
        -1, keepdim=True)
    tm = torch.nn.functional.normalize(t, dim=-1).abs().amax(-1)
    _close(got, ref, BF16_ULP, 1e-3, ref.float().abs() + scale * xm * tm)
    assert bool(got[..., 0].float().any()) == (k == 1)
