"""The port's tensor parallelism against the JAX package's (`lseg_tpu/
parallel/mesh.py`'s `_TP_RULES`, the `tp_layout` ViT, `__graft_entry__.
dryrun_multichip`), on the CPU with four gloo ranks in a 2 x 2
("data", "model") mesh.

The four ranks run once for the module (`tests/torch_tp_worker.py`, a file
store in a temporary directory); each case below reads their results. The
JAX side runs in this process on the conftest's eight virtual CPU
devices, with the port's seeded weights carried into the JAX tree
(`torch_parity.seeded_variables`) and inputs made from seeds with numpy.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import perturb, seeded_variables
from torch_parallel_worker import int8_tree
from torch_tp_worker import N_DATA, N_MODEL, flat_config, tp_layout_config

from lseg_tpu.models.clip_text import CLIPTextEncoder as JText
from lseg_tpu.testing import TINY_TEXT as J_TINY_TEXT
from lseg_tpu.testing import tiny_vit_config as j_tiny_vit_config
from lseg_tpu.utils.checkpoint_convert import to_tp_layout
from lseg_tpu_torch.graft_entry import dryrun_multichip
from lseg_tpu_torch.models.clip_text import CLIPTextEncoder
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.parallel import Mesh, param_shardings
from lseg_tpu_torch.testing import TINY_TEXT, tiny_vit_config
from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer
from lseg_tpu_torch.utils.convert import (
    from_jax_text_params,
    from_jax_variables,
    to_jax_variables,
)

WORKER = Path(__file__).resolve().parent / "torch_tp_worker.py"
WORLD = N_DATA * N_MODEL
LABELS = ["the cat", "dog", "other", "grass and stone", "plant", "sky"]
# the JAX package's `test_sharded_train_step_matches_single_device`
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6
# the gathered gradients against one process's, fp32 on both sides, a
# relative norm a tensor: the row-parallel sums run in another order
GRAD_REL = 1e-5
# fp32 forwards: the tolerance of `test_text_encoder_fp32_matches_jax`
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    cfg = j_tiny_vit_config()
    v = seeded_variables(cfg)
    vf = seeded_variables(flat_config(cfg), seed=4)
    x = rng.randn(4, 64, 64, 3).astype(np.float32)
    tgt = rng.randint(0, 4, (4, 64, 64)).astype(np.int32)
    tgt[0, :24] = -1  # the data shards hold different ignored counts
    txt = rng.randn(4, 64).astype(np.float32)
    xq = rng.randn(4, 64, 64, 3).astype(np.float32)
    tokens = ClipBPETokenizer.for_tests(J_TINY_TEXT.context_length)(LABELS)
    tv = perturb(JText(J_TINY_TEXT).init(jax.random.PRNGKey(0),
                                         jnp.asarray(tokens)))
    vtp = {"params": to_tp_layout(v["params"], cfg.vit.num_heads),
           "batch_stats": v["batch_stats"]}
    return {"v": v, "vf": vf, "vtp": vtp, "tv": tv,
            "np": {"x": x, "tgt": tgt, "txt": txt, "tokens": tokens},
            "torch": {"x": torch.from_numpy(x),
                      "tgt": torch.from_numpy(tgt).long(),
                      "txt": torch.from_numpy(txt),
                      "xq": torch.from_numpy(xq),
                      "tokens": torch.from_numpy(tokens),
                      "labels": LABELS,
                      "tiny": from_jax_variables(v),
                      "flat": from_jax_variables(vf),
                      "tp": from_jax_variables(vtp),
                      "text": from_jax_text_params(tv["params"]),
                      "tiny_q": int8_tree(xq, txt)}}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The four ranks' results (one run for the module)."""
    d = tmp_path_factory.mktemp("tensor_parallel")
    torch.save(inputs["torch"], d / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(WORLD), str(d / "store"),
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return [torch.load(d / f"out_{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _spec(spec) -> tuple:
    return tuple(spec)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_param_shardings_match_jax(inputs):
    """The port's split of every LSegNet parameter on a 4 x 2 mesh against
    `lseg_tpu.parallel.param_shardings`: a JAX spec over a stacked block
    leaf (L, in, out) drops the block axis and turns to the port's (out,
    in) weight. The JAX text rules name `resblocks/blocks/...`, which the
    text tower's tree (`resblocks/...`) never holds, so JAX replicates it;
    the port cuts the tower as the rules intend: its specs equal the JAX
    rules' on the tree re-rooted at `resblocks/blocks`."""
    from lseg_tpu.parallel import create_mesh as j_create_mesh
    from lseg_tpu.parallel import param_shardings as j_param_shardings

    jmesh = j_create_mesh(n_data=4, n_model=2)
    mesh = Mesh(4, 2)
    cfg = tiny_vit_config()
    specs = param_shardings(LSegNet(cfg), mesh)
    jspecs = {p: _spec(s.spec) for p, s in _leaves(
        j_param_shardings(inputs["v"]["params"], jmesh))}
    hooks = cfg.vit.hooks
    cut = 0
    for name, spec in specs.items():
        parts = name.split(".")
        if parts[:2] != ["vit", "blocks"]:
            assert spec == (), name
            continue
        k = int(parts[2])
        seg = next(s for s, h in enumerate(hooks) if k <= h)
        base = ("vit", f"seg{seg}", "blocks", *parts[3:-1])
        leaf = parts[-1]
        if leaf == "weight":
            leaf = "kernel" if base + ("kernel",) in jspecs else "scale"
        js = jspecs[base + (leaf,)][1:]
        if leaf == "kernel":
            js = js[::-1]
        assert spec == js, (name, spec, js)
        cut += spec != ()
    assert cut == 6 * (hooks[-1] + 1)
    assert all(s == () for p, s in jspecs.items()
               if not (p[0] == "vit" and p[2:3] == ("blocks",)))

    tparams = inputs["tv"]["params"]
    dead = j_param_shardings(tparams, jmesh)
    assert all(_spec(s.spec) == () for _, s in _leaves(dead))
    rerooted = dict(tparams, resblocks={"blocks": tparams["resblocks"]})
    tspecs = {p: _spec(s.spec) for p, s in _leaves(
        j_param_shardings(rerooted, jmesh))}
    enc_specs = param_shardings(CLIPTextEncoder(TINY_TEXT), mesh)
    for name, spec in enc_specs.items():
        parts = name.split(".")
        if parts[0] != "resblocks":
            assert spec == (), name
            continue
        base = ("resblocks", "blocks", *parts[2:-1])
        leaf = parts[-1]
        if leaf == "weight":
            leaf = "kernel" if base + ("kernel",) in tspecs else "scale"
        js = tspecs[base + (leaf,)][1:]
        if leaf == "kernel":
            js = js[::-1]
        assert spec == js, (name, spec, js)


def _jax_step(cfg, v, a, mesh=None):
    """JAX's `make_train_step` on the global batch, on one device or
    sharded over `mesh` as `test_sharded_train_step_matches_single_
    device` shards it."""
    from lseg_tpu.models.lseg import LSegNet as JLSegNet
    from lseg_tpu.parallel import batch_sharding, replicated, shard_state
    from lseg_tpu.train import create_train_state
    from lseg_tpu.train import make_optimizer as jmake_optimizer
    from lseg_tpu.train import make_train_step as jmake_train_step

    state = create_train_state(JLSegNet(cfg), v,
                               jmake_optimizer(0.01, 100, batch_size=4))
    batch = {"image": jnp.asarray(a["x"]), "target": jnp.asarray(a["tgt"])}
    txt = jnp.asarray(a["txt"])
    if mesh is not None:
        state = jax.device_put(state, shard_state(state, mesh))
        batch = jax.device_put(batch, batch_sharding(mesh))
        txt = jax.device_put(txt, replicated(mesh))
    new, m = jax.jit(jmake_train_step(-1))(state, batch, txt)
    return float(m["loss"]), int(m["labeled"]), from_jax_variables(
        {"params": new.params, "batch_stats": new.batch_stats})


@pytest.mark.parametrize("which", ["tiny", "flat"])
def test_tp_train_step_matches_jax(ranks, inputs, which):
    """One step on the 2 x 2 mesh (each data shard 2 rows, each model
    group cutting the float ViT blocks over two ranks) against JAX's
    single-device step on the 4 rows: the tiny config (one head a rank,
    einsum attention; also against JAX's 4 x 2 step) and a flat-eligible
    one (width 256, four heads: two heads of 64 a rank run
    `FlashAttentionFlat`'s plain twin, forward and backward). The four
    ranks' gathered states are equal bit for bit."""
    from lseg_tpu.parallel import create_mesh as j_create_mesh

    a = inputs["np"]
    cfg = j_tiny_vit_config()
    refs = []
    if which == "tiny":
        refs.append(_jax_step(cfg, inputs["v"], a))
        refs.append(_jax_step(cfg, inputs["v"], a, j_create_mesh(4, 2)))
    else:
        refs.append(_jax_step(flat_config(cfg), inputs["vf"], a))
    got = [r["train"][which] for r in ranks]
    heads = 1 if which == "tiny" else 2
    for g in got:
        assert g["heads"] == [heads] * len(g["heads"])
        assert all(g["flat"]) == (which == "flat")
        assert g["labeled"] == refs[0][1]
    first = got[0]["gathered"]
    for g in got[1:]:
        assert list(g["gathered"]) == list(first)
        for name, t in g["gathered"].items():
            np.testing.assert_array_equal(t.numpy(), first[name].numpy(),
                                          err_msg=name)
    for loss, _, ref in refs:
        for g in got:
            np.testing.assert_allclose(g["loss"], loss, rtol=LOSS_RTOL)
        assert set(ref) == set(first)
        for name, r in ref.items():
            np.testing.assert_allclose(first[name].numpy(), r.numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("which", ["tiny", "flat"])
def test_gathered_grads_match_one_process(ranks, which):
    """`gather_grads` after the step: every rank's whole gradients, the
    cut parameters' parts gathered over the model group, equal one
    process's step on the global batch within GRAD_REL (a relative norm a
    tensor), for the cut and the replicated parameters alike."""
    for r in ranks:
        got, one = r["train"][which]["grads"], r["train"][which]["one_grads"]
        assert list(got) == list(one)
        for name, g in got.items():
            assert g.shape == one[name].shape, name
            rel = float((g - one[name]).norm() / one[name].norm())
            assert rel <= GRAD_REL, (name, rel)


def test_replicated_params_equal_across_model_groups(ranks):
    """After the step, each rank holds half of every cut projection (its
    own half: the two ranks of a model group differ there) and the
    replicated parameters and statistics bit for bit equal to its model
    group's other rank's."""
    for which in ("tiny", "flat"):
        by_coord = {tuple(r["coord"]): r["train"][which] for r in ranks}
        for d in range(N_DATA):
            a, b = by_coord[d, 0]["local"], by_coord[d, 1]["local"]
            full = by_coord[d, 0]["gathered"]
            cut = 0
            for name, t in a.items():
                if t.shape == full[name].shape:
                    np.testing.assert_array_equal(t.numpy(),
                                                  b[name].numpy(),
                                                  err_msg=name)
                else:
                    assert t.numel() * N_MODEL == full[name].numel(), name
                    assert not torch.equal(t, b[name]), name
                    cut += 1
            # qkv's and fc1's weight and bias, proj's and fc2's weight,
            # in each of the four blocks
            assert cut == 6 * 4


def test_export_params_gathers_the_cut_model(ranks):
    """`train.checkpoint.export_params` on a cut model writes the whole
    model, the file one process would write: read back, it equals the
    gathered state bit for bit on every rank."""
    for r in ranks:
        got, full = r["train"]["tiny"]["exported"], r["train"]["tiny"][
            "gathered"]
        assert set(got) == set(full)
        for name, t in full.items():
            np.testing.assert_array_equal(got[name].numpy(), t.numpy(),
                                          err_msg=name)


def test_tp_layout_forward_matches_jax(ranks, inputs):
    """The `tp_layout` model, its head-major tree carried across
    (`from_jax_variables` reshapes it), its rows over the data groups and
    its heads over the model groups, against JAX's `tp_layout=True` model
    on `to_tp_layout` params; the head-major tree reads to the flat
    layout's state bit for bit and `to_jax_variables(tp_heads=H)` writes
    it back."""
    from lseg_tpu.models.lseg import LSegNet as JLSegNet

    cfg = j_tiny_vit_config()
    a = inputs["np"]
    ref = np.asarray(jax.jit(JLSegNet(tp_layout_config(cfg)).apply)(
        inputs["vtp"], jnp.asarray(a["x"]), jnp.asarray(a["txt"])))
    for r in ranks:
        assert r["tp_layout"].shape == ref.shape
        np.testing.assert_allclose(r["tp_layout"].numpy(), ref,
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
    flat = inputs["torch"]["tiny"]
    for name, t in inputs["torch"]["tp"].items():
        np.testing.assert_array_equal(t.numpy(), flat[name].numpy(),
                                      err_msg=name)
    back = to_jax_variables(flat, cfg.vit.hooks,
                            tp_heads=cfg.vit.num_heads)
    want = dict(_leaves(inputs["vtp"]["params"]))
    got = dict(_leaves(back["params"]))
    assert set(got) == set(want)
    for p, arr in want.items():
        np.testing.assert_array_equal(got[p], np.asarray(arr), err_msg=p)


def test_text_features_match_jax(ranks, inputs):
    """The CLIP text tower cut over each model group of two
    (`encode_labels(..., mesh=...)`, one head a rank) against JAX's
    unsharded tower on the same tokens, on every rank."""
    ref = np.asarray(jax.jit(JText(J_TINY_TEXT).apply)(
        inputs["tv"], jnp.asarray(inputs["np"]["tokens"])))
    for r in ranks:
        assert r["text"].shape == (len(LABELS), J_TINY_TEXT.embed_dim)
        np.testing.assert_allclose(r["text"], ref, rtol=FWD_RTOL,
                                   atol=FWD_ATOL)


def test_fast_cal_labels_under_mesh_equal_one_process(ranks):
    """fast_cal's label map from `make_data_sharded_predictor` under the
    2 x 2 mesh (its int8 blocks stay whole, so each model group runs its
    data shard whole on both ranks) equals one process's call on the 4
    rows, and each rank's rows equal one process's call on its shard, bit
    for bit."""
    for r in ranks:
        out = r["fast_cal"]
        d = r["coord"][0]
        np.testing.assert_array_equal(out["labels"].numpy(),
                                      out["one_process"].numpy())
        np.testing.assert_array_equal(
            out["labels"][2 * d:2 * d + 2].numpy(), out["shard"].numpy())


def test_dryrun_multichip():
    """`python -m lseg_tpu_torch.graft_entry dryrun 4`'s function: four
    gloo ranks over a 2 x 2 mesh, each of its three checks held against
    one process inside the ranks."""
    summary = dryrun_multichip(4, device="cpu")
    assert summary["mesh"] == [2, 2]
    assert summary["eval_tp_logits"] == [4, 64, 64, 5]
    assert summary["fast_int8_batch"] == 4
    assert np.isfinite(summary["loss"])


def test_dryrun_needs_the_card_unless_asked(monkeypatch, capsys):
    """The dryrun runs its ranks on the card by default: without CUDA it
    refuses, the function and the command line alike, rather than fall
    back to the CPU; `device='cpu'` / `--device cpu` ask for the CPU."""
    from lseg_tpu_torch import graft_entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
    assert graft_entry.main(["dryrun", "2"]) == 1
    assert "--device cpu" in capsys.readouterr().err
