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
    SCALE_SHAPES,
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


# ---- the CUDA kernels against their plain versions (on the card) ----

def _close(got, ref, rtol, atol, magnitude=None):
    """|got - ref| <= atol + rtol * magnitude (default |ref|) everywhere."""
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    d = (got.float() - ref.float()).abs()
    mag = ref.float().abs() if magnitude is None else magnitude
    assert bool((d <= atol + rtol * mag).all()), float(d.max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,residual", [
    ((1802, 4096, 1024), torch.bfloat16, torch.bfloat16),
    ((1802, 1024, 1024), torch.bfloat16, None),
    ((70, 128, 96), torch.float32, torch.float32),
    ((70, 128, 96), torch.float32, None)])
def test_dense_residual_kernel_matches_plain(cuda_device, shape, dtype,
                                             residual):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    args = probe.dense_inputs(cuda_device, g, *shape, dtype=dtype,
                              residual=residual)
    before = dense_residual.launches
    out_dtype = dtype
    got = dense_residual(*args, out_dtype=out_dtype)
    assert dense_residual.launches == before + 1
    rtol, atol = ((probe.DENSE_RTOL, probe.DENSE_ATOL)
                  if dtype == torch.bfloat16 else
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
@pytest.mark.parametrize("shape,k,dt", [
    ((2, 240, 240, 512), 150, torch.bfloat16),
    ((1, 7, 9, 64), 21, torch.float32)])
def test_fused_correlate_bf16_kernel_matches_plain(cuda_device, shape, k,
                                                   dt):
    """bf16 logits within 1e-3 plus one bf16 ulp (2^-7) of |plain| + scale *
    max|xn| * max|tn|: fp32 sums in another order and one rounding to
    bf16, and one normalised operand that may round to bf16 one ulp apart
    where the kernel's fp32 norm and the twin's differ in the last bit."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(shape, device=cuda_device, generator=g).to(dt)
    t = torch.randn(k, shape[-1], device=cuda_device, generator=g)
    t[0] = 0.0
    scale = 1.0 / 0.07
    got = fused_correlate(x, t, compute_dtype=torch.bfloat16)
    ref = fused_correlate_plain(x, t, compute_dtype=torch.bfloat16)
    xm = torch.nn.functional.normalize(x.float(), dim=-1).abs().amax(
        -1, keepdim=True)
    tm = torch.nn.functional.normalize(t, dim=-1).abs().amax(-1)
    _close(got, ref, BF16_ULP, 1e-3, ref.float().abs() + scale * xm * tm)
    assert not got[..., 0].float().any()
