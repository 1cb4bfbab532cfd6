"""The port stands alone: no module of `lseg_tpu_torch`, and not
`chip_smoke.py`, imports `lseg_tpu` or `jax`; and its own copies of the
framework-free modules (config, labels, tokenizer, the data readers,
the native decode binding, the few-shot episodes and their visualizer,
`utils/sinks.py`, `utils/palette.py`) and pieces (the checkpoint reader, the reference-file
writers, the TTA protocol and plan) have not drifted from the JAX
package's: each equals its original apart from its import statements."""

import ast
import dataclasses
import importlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest

from lseg_tpu import config as jconfig
from lseg_tpu.data.labels import get_labels as j_get_labels
from lseg_tpu.text.tokenizer import ClipBPETokenizer as JTokenizer
from lseg_tpu_torch import config as tconfig
from lseg_tpu_torch.data.labels import get_labels
from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer

REPO = Path(__file__).resolve().parent.parent
REFUSED = ("lseg_tpu", "jax", "jaxlib", "flax")

# Runs in a fresh interpreter: a meta-path finder refuses the JAX package
# and JAX (and Streamlit, which only the app's page imports), then every
# module of the port is imported (the few-shot modules, `test_zs`, the
# HSNet side-car, the app, `parallel.tensor` and `graft_entry` among them)
# and the --help of the port's command lines runs.
_IMPORT_ALL = """
import importlib.abc, pkgutil, runpy, sys

REFUSED = {refused!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {{name}}")
        return None

sys.meta_path.insert(0, Refuse())
import lseg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lseg_tpu_torch.__path__,
                                               "lseg_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the tensor-parallel modules and the graft entry points among them
assert {{"lseg_tpu_torch.parallel.tensor",
         "lseg_tpu_torch.graft_entry"}} <= set(names), names
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
for cli in ("lseg_tpu_torch.train", "lseg_tpu_torch.test_zs",
            "lseg_tpu_torch.hsnet_run", "lseg_tpu_torch.demo",
            "lseg_tpu_torch.parity_check", "lseg_tpu_torch.graft_entry"):
    sys.argv = [cli, "--help"]
    try:
        runpy.run_module(cli, run_name="__main__")
    except SystemExit as e:
        assert e.code in (0, None), e.code
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print("imported", len(names))
"""


def test_port_imports_without_lseg_tpu_or_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(
            refused=REFUSED + ("streamlit",))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "--device" in proc.stdout  # the CLIs' help ran
    assert "zero-shot eval" in proc.stdout and "--nshot" in proc.stdout
    for prog in ("usage: hsnet", "usage: lseg_tpu demo",
                 "usage: lseg_tpu parity check",
                 "usage: python -m lseg_tpu_torch.graft_entry"):
        assert prog in proc.stdout, prog
    n = int(proc.stdout.strip().splitlines()[-1].split()[-1])
    assert n >= 40


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_name_no_lseg_tpu_or_jax_import():
    files = sorted((REPO / "lseg_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in REFUSED]
    assert len(files) > 40 and not bad, bad


def _config_cases():
    return [(b, q) for b in sorted(jconfig.BACKBONES)
            for q in (None, False, "static", "static_cal")]


@pytest.mark.parametrize("backbone,quant", _config_cases())
def test_config_copy_matches_reference(backbone, quant):
    """get_config (and fast_serving of it) of both packages agree field by
    field."""
    ref = jconfig.get_config(backbone)
    got = tconfig.get_config(backbone)
    if quant is not None:
        ref = jconfig.fast_serving(ref, quant)
        got = tconfig.fast_serving(got, quant)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert type(got).__name__ == type(ref).__name__


def test_config_copy_has_the_reference_backbones_and_helpers():
    assert sorted(tconfig.BACKBONES) == sorted(jconfig.BACKBONES)
    for d, h in ((1024, 16), (768, 12), (100, 2), (128, 3)):
        for layout in (False, True):
            assert tconfig.flat_flash_eligible(d, h, layout) == \
                jconfig.flat_flash_eligible(d, h, layout)


@pytest.mark.parametrize("dataset", [
    "ade20k", "citys", "pascal_voc", "pascal_aug", "pcontext", "coco",
    "fss", "pascal"])
def test_packaged_labels_match_reference(dataset):
    got = get_labels(dataset)
    assert got == j_get_labels(dataset) and len(got) > 1


def test_tokenizer_copy_matches_reference():
    labels = ["the cat", "other", "dog", "a tree", "sky-scraper", "t.v.",
              "hot dog", "ÉCOLE"]
    for n in (16, 77):
        got = ClipBPETokenizer.for_tests(n)(labels)
        ref = JTokenizer.for_tests(n)(labels)
        assert got.tolist() == ref.tolist()


def _without_imports(src: str) -> str:
    """`src` minus the lines of its import statements (at any depth)."""
    drop = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno, node.end_lineno + 1))
    return "\n".join(line for i, line in enumerate(src.splitlines(), 1)
                     if i not in drop)


@pytest.mark.parametrize("module", [
    "data/labels", "data/transforms", "data/synthetic", "data/ade20k",
    "data/voc", "data/coco", "data/cityscapes", "utils/sinks",
    "text/tokenizer", "data/native", "data/fewshot", "utils/fewshot_vis",
    "utils/palette"])
def test_module_copy_matches_reference(module):
    ref = (REPO / "lseg_tpu" / f"{module}.py").read_text()
    got = (REPO / "lseg_tpu_torch" / f"{module}.py").read_text()
    assert _without_imports(got) == _without_imports(ref)


_PIECES = {
    "utils.checkpoint_convert": ("_TorchUnpickler", "_StorageType", "_Stub",
                                 "_rebuild_tensor", "load_torch_file",
                                 "extract_state_dict"),
    "testing": ("write_reference_ckpt", "write_reference_vocab",
                "tiny_vit_config", "tiny_rn_config"),
    "engine.tta": ("TTAProtocol", "TTAPlan", "make_plan", "_resize_np",
                   "build_pyramid"),
}


@pytest.mark.parametrize("module,name", [
    (m, n) for m, names in _PIECES.items() for n in names])
def test_copied_piece_matches_reference(module, name):
    ref = getattr(importlib.import_module(f"lseg_tpu.{module}"), name)
    got = getattr(importlib.import_module(f"lseg_tpu_torch.{module}"), name)
    assert _without_imports(inspect.getsource(got)) == _without_imports(
        inspect.getsource(ref))


def test_checkpoint_reader_dtypes_match_reference():
    from lseg_tpu.utils import checkpoint_convert as ref
    from lseg_tpu_torch.utils import checkpoint_convert as got

    assert got._DTYPES == ref._DTYPES
