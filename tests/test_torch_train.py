"""The port's training stack against the JAX package's: BatchNorm train
mode, losses and metrics, the optimizer, one whole train step (with and
without gradient accumulation), the loader's index stream, checkpoints
and resume, the command line, and serving staying graph-free once
parameters require grad."""

import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import jax_lseg_variables, tiny_parity_config

from lseg_tpu.data.synthetic import SyntheticSegDataset
from lseg_tpu.ops import losses as jlosses
from lseg_tpu.ops.metrics import seg_update as jseg_update
from lseg_tpu.train.optim import make_optimizer as jmake_optimizer
from lseg_tpu_torch.data.loader import DataLoader
from lseg_tpu_torch.models.layers import BatchNorm, random_init_
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.ops.losses import cross_entropy, segmentation_loss
from lseg_tpu_torch.ops.metrics import SegmentationMetric, seg_update
from lseg_tpu_torch.train.checkpoint import CheckpointManager
from lseg_tpu_torch.train.loop import FitConfig, fit
from lseg_tpu_torch.train.optim import make_optimizer
from lseg_tpu_torch.train.step import (
    TrainState,
    enable_grads,
    make_eval_step,
    make_train_step,
)
from lseg_tpu_torch.utils.convert import from_jax_variables

REPO = Path(__file__).resolve().parents[1]


def flashflat_config():
    cfg = tiny_parity_config()
    return dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, attn_impl="flashflat"))


# --- BatchNorm --------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5, 5, 8), (1, 2, 2, 4)],
                         ids=["n50", "n4"])
def test_batchnorm_train_matches_flax(shape):
    """Output and running statistics of one train-mode call, then the
    eval-mode output on the updated statistics. At n4 the unbiased
    variance is 4/3 of the biased one, which the update must not use."""
    rng = np.random.RandomState(0)
    x = (3.0 + 2.0 * rng.randn(*shape)).astype(np.float32)
    c = shape[-1]
    scale = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    mean0 = (0.1 * rng.randn(c)).astype(np.float32)
    var0 = (1.0 + 0.1 * np.abs(rng.randn(c))).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    ref, mut = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    ref_eval = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                             epsilon=1e-5).apply(
        {"params": variables["params"], **mut}, jnp.asarray(x))

    port = BatchNorm(c)
    port.load_state_dict({"weight": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean0),
                          "running_var": torch.from_numpy(var0)})
    port.train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)
    stats = mut["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-6,
                               rtol=1e-6)
    port.eval()
    np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(),
                               np.asarray(ref_eval), atol=1e-6, rtol=1e-6)
    if shape == (1, 2, 2, 4):
        xs = x.reshape(-1, c)
        biased = 0.9 * var0 + 0.1 * xs.var(axis=0)
        unbiased = 0.9 * var0 + 0.1 * xs.var(axis=0, ddof=1)
        assert np.abs(biased - unbiased).min() > 1e-2
        np.testing.assert_allclose(port.running_var.numpy(), biased,
                                   rtol=1e-5)


# --- losses and metrics -----------------------------------------------


def _seg_inputs(seed=0, k=5):
    rng = np.random.RandomState(seed)
    logits = rng.randn(2, 8, 8, k).astype(np.float32)
    target = rng.randint(-1, k, (2, 8, 8)).astype(np.int32)
    return logits, target


def test_cross_entropy_matches_jax():
    logits, target = _seg_inputs()
    ref = float(jlosses.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(target), -1))
    got = float(cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(target), -1))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_segmentation_loss_with_aux_and_se_matches_jax():
    logits, target = _seg_inputs(1)
    rng = np.random.RandomState(2)
    aux = rng.randn(*logits.shape).astype(np.float32)
    se = rng.randn(2, 5).astype(np.float32)
    ref = float(jlosses.segmentation_loss(
        jnp.asarray(logits), jnp.asarray(target), aux_logits=jnp.asarray(aux),
        se_logits=jnp.asarray(se), nclass=5))
    got = float(segmentation_loss(
        torch.from_numpy(logits), torch.from_numpy(target),
        aux_logits=torch.from_numpy(aux), se_logits=torch.from_numpy(se),
        nclass=5))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    se_ref = float(jlosses.se_loss(jnp.asarray(se), jnp.asarray(target), 5))
    from lseg_tpu_torch.ops.losses import se_loss

    np.testing.assert_allclose(
        float(se_loss(torch.from_numpy(se), torch.from_numpy(target), 5)),
        se_ref, rtol=1e-6)


def test_seg_update_matches_jax():
    logits, target = _seg_inputs(3)
    ref = jseg_update(jnp.asarray(logits), jnp.asarray(target), 5, -1)
    got = seg_update(torch.from_numpy(logits), torch.from_numpy(target), 5,
                     -1)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    meter = SegmentationMetric(5)
    meter.update(torch.from_numpy(logits), torch.from_numpy(target))
    correct, labeled, inter, union = (np.asarray(r, np.float64) for r in ref)
    eps = np.spacing(1.0)
    assert meter.get() == (float(correct / (eps + labeled)),
                           float(np.mean(inter / (eps + union))))


# --- optimizer --------------------------------------------------------


class _TwoGroups(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        for top, leaves in tree.items():
            mod = torch.nn.Module()
            for name, a in leaves.items():
                setattr(mod, name, torch.nn.Parameter(torch.from_numpy(a)))
            self.add_module(top, mod)


@pytest.mark.parametrize("midas_proto", [False, True], ids=["sgd", "adam"])
@pytest.mark.parametrize("freeze", [False, True], ids=["all", "frozen"])
def test_optimizer_matches_optax(midas_proto, freeze):
    """Three steps with the same gradients, both groups (backbone `vit`,
    decoder at 10x), weight decay on every leaf, the poly schedule."""
    rng = np.random.RandomState(0)
    tree = {"vit": {"w": rng.randn(3, 4).astype(np.float32),
                    "b": rng.randn(4).astype(np.float32)},
            "head1": {"weight": rng.randn(2, 3).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), tree)
        for _ in range(3)]
    kw = dict(batch_size=8, midas_proto=midas_proto, freeze_backbone=freeze)
    tx = jmake_optimizer(0.004, 10, **kw)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(params)
    model = _TwoGroups(tree)
    opt = make_optimizer(model, 0.004, 10, **kw)
    for k, g in enumerate(grads):
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)
        for top, leaves in g.items():
            for name, a in leaves.items():
                p = getattr(getattr(model, top), name)
                p.grad = torch.from_numpy(a) if p.requires_grad else None
        opt.step(k)
    for top, leaves in params.items():
        for name, a in leaves.items():
            np.testing.assert_allclose(
                getattr(getattr(model, top), name).detach().numpy(),
                np.asarray(a), rtol=1e-6, atol=1e-6, err_msg=f"{top}.{name}")
    if freeze:
        np.testing.assert_array_equal(model.vit.w.detach().numpy(),
                                      tree["vit"]["w"])


# --- the slice: one train step against JAX's --------------------------


def _batch(n, seed=0, k=4, out_c=64):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 64, 64, 3).astype(np.float32)
    tgt = rng.randint(-1, k, (n, 64, 64)).astype(np.int32)
    txt = rng.randn(k, out_c).astype(np.float32)
    return x, tgt, txt


def _port_state(cfg, variables, remat=True):
    model = LSegNet(cfg, torch.float32, remat=remat,
                    param_dtype=torch.float32)
    model.load_state_dict(from_jax_variables(variables))
    enable_grads(model)
    opt = make_optimizer(model, 0.004, 1000, batch_size=16)
    return TrainState(model, opt)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_step_matches_jax(accumulate):
    """fp32, flashflat (the port's Function with the plain twins, remat
    on; JAX's Pallas kernels in interpret mode), the same perturbed tree:
    loss, every updated parameter and the BatchNorm statistics."""
    from lseg_tpu.models.lseg import LSegNet as JLSegNet
    from lseg_tpu.train import create_train_state
    from lseg_tpu.train import make_train_step as jmake_train_step

    cfg = flashflat_config()
    n = 2 * accumulate
    x, tgt, txt = _batch(n)
    v = jax_lseg_variables(cfg, x[:1], txt)
    jstate = create_train_state(JLSegNet(cfg), v, jmake_optimizer(
        0.004, 1000, batch_size=16))
    jnew, jm = jax.jit(jmake_train_step(-1, accumulate))(
        jstate, {"image": jnp.asarray(x), "target": jnp.asarray(tgt)},
        jnp.asarray(txt))
    ref = from_jax_variables({"params": jnew.params,
                              "batch_stats": jnew.batch_stats})

    state = _port_state(cfg, v)
    state, m = make_train_step(-1, accumulate)(
        state, {"image": torch.from_numpy(x),
                "target": torch.from_numpy(tgt).long()},
        torch.from_numpy(txt))
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert int(m["labeled"]) == int(jm["labeled"])
    got = state.model.state_dict()
    assert set(got) == set(ref)
    for name, r in ref.items():
        if name.endswith(("running_mean", "running_var")):
            tol = dict(rtol=1e-5, atol=1e-5)
        else:
            tol = dict(rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(got[name].numpy(), r.numpy(),
                                   err_msg=name, **tol)


def test_overfit_loss_decreases():
    cfg = flashflat_config()
    x, tgt, txt = _batch(2, seed=4)
    v = jax_lseg_variables(cfg, x[:1], txt)
    state = _port_state(cfg, v)
    step = make_train_step()
    batch = {"image": torch.from_numpy(x),
             "target": torch.from_numpy(tgt).long()}
    txt_t = torch.from_numpy(txt)
    state, m0 = step(state, batch, txt_t)
    for _ in range(8):
        state, m = step(state, batch, txt_t)
    assert float(m["loss"]) < float(m0["loss"])
    assert state.step == 9
    ev = make_eval_step()(state, batch, txt_t)
    assert not state.model.training and np.isfinite(float(ev["loss"]))


# --- loader, checkpoints, resume, command line ------------------------


def test_loader_index_stream_matches_reference():
    from lseg_tpu.data.loader import DataLoader as JDataLoader

    ds = SyntheticSegDataset(n=11, size=16, num_classes=3)
    ref = JDataLoader(ds, 3, shuffle=True, num_workers=2)
    got = DataLoader(ds, 3, shuffle=True, num_workers=2, device="cpu")
    assert len(got) == len(ref) == 3
    for epoch in (0, 4):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        for r, g in zip(ref, got):
            assert g["image"].dtype == torch.float32
            np.testing.assert_array_equal(g["image"].numpy(), r["image"])
            np.testing.assert_array_equal(g["target"].numpy(), r["target"])


@pytest.fixture(scope="module")
def tiny_state_factory():
    cfg = flashflat_config()
    x, tgt, txt = _batch(2, seed=6)
    v = jax_lseg_variables(cfg, x[:1], txt)
    return lambda: _port_state(cfg, v), txt


def test_checkpoint_restore_is_bit_exact(tiny_state_factory, tmp_path):
    make, txt = tiny_state_factory
    state = make()
    x, tgt, _ = _batch(2, seed=7)
    state, _ = make_train_step()(
        state, {"image": torch.from_numpy(x),
                "target": torch.from_numpy(tgt).long()},
        torch.from_numpy(txt))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, state, {"epoch": 3})
    fresh = make()
    assert mgr.restore(fresh) is fresh and fresh.step == state.step == 1
    assert mgr.latest_metrics() == {"epoch": 3.0}
    a, b = state.model.state_dict(), fresh.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    oa, ob = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, s in oa["state"].items():
        assert torch.equal(s["momentum_buffer"],
                           ob["state"][i]["momentum_buffer"])
    # last + best by val_acc, max_to_keep 3
    for step, acc in ((2, 0.9), (3, 0.1), (4, 0.5), (5, 0.2), (6, 0.0)):
        mgr.save(step, state, {"val_acc": acc, "epoch": step})
    assert mgr.steps() == [2, 4, 5, 6]


class _SignalAfter:
    """Loader that sends this process SIGTERM during its first epoch."""

    def __init__(self, loader):
        self.loader, self.sent = loader, False

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for batch in self.loader:
            if not self.sent:
                self.sent = True
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def test_fit_stops_on_sigterm_and_resumes(tiny_state_factory, tmp_path):
    make, txt = tiny_state_factory
    ds = SyntheticSegDataset(n=4, size=64, num_classes=4)
    txt_t = torch.from_numpy(txt)
    cfg = FitConfig(max_epochs=3, ckpt_dir=str(tmp_path), tensorboard=False,
                    log_every=1)
    logs = []
    loader = _SignalAfter(DataLoader(ds, 2, num_workers=1, device="cpu"))
    state = fit(make(), loader, txt_t, cfg, log=logs.append)
    assert state.step == 2
    assert any("stopping after epoch 0" in s for s in logs)
    assert signal.getsignal(signal.SIGTERM) is not None
    logs.clear()
    val = DataLoader(SyntheticSegDataset(n=2, size=64, num_classes=4,
                                         seed=1), 2, shuffle=False,
                     device="cpu")
    state = fit(make(), DataLoader(ds, 2, num_workers=1, device="cpu"),
                txt_t, cfg,
                val_loader=val, log=logs.append)
    assert "resumed from step 2 (epoch 1)" in logs
    assert state.step == 6
    rows = (tmp_path / "metrics.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows] == ["epoch", "0", "1", "2"]
    assert rows[-1].split(",")[3] != ""  # val_acc


def test_cli_dry_run_writes_metrics(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "lseg_tpu_torch.train", "--dataset",
         "synthetic", "--dry-run", "--crop_size", "64", "--batch_size", "2",
         "--num_workers", "1", "--dtype", "float32", "--device", "cpu",
         "--ckpt_root", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = (tmp_path / "lseg" / "metrics.csv").read_text().splitlines()
    assert len(rows) == 11 and rows[0].startswith("epoch,loss")
    proc = subprocess.run(
        [sys.executable, "-m", "lseg_tpu_torch.train", "--dataset",
         "synthetic", "--ckpt", "x.npz", "--crop_size", "64", "--device",
         "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "x.npz" in proc.stderr


def test_cli_without_card_names_the_device_flag(tmp_path):
    """No silent CPU: without a card the CLI refuses to start unless it
    is told `--device cpu`."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "lseg_tpu_torch.train", "--dataset",
         "synthetic", "--dry-run", "--crop_size", "64", "--ckpt_root",
         str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert not (tmp_path / "lseg").exists()


# --- training model vs serving model, graph-free serving --------------


def test_training_model_forward_equals_serving_model():
    """The same converted tree (params + batch_stats) in a bf16 serving
    model and a training model with fp32 masters: identical eval
    forwards, since the training model rounds its masters at each call
    exactly as load_state_dict rounds them into bf16 storage."""
    cfg = tiny_parity_config()
    x, _, txt = _batch(1, seed=8)
    sd = from_jax_variables(jax_lseg_variables(cfg, x, txt))
    serve = LSegNet(cfg, torch.bfloat16)
    serve.load_state_dict(sd)
    train = LSegNet(cfg, torch.bfloat16, remat=True,
                    param_dtype=torch.float32)
    train.load_state_dict(sd)
    assert serve.head1.weight.dtype == torch.bfloat16
    assert train.head1.weight.dtype == torch.float32
    for k, t in train.state_dict().items():
        assert torch.equal(t, sd[k].to(t.dtype)), k
    enable_grads(train)
    with torch.no_grad():
        a = serve(torch.from_numpy(x), torch.from_numpy(txt))
        b = train(torch.from_numpy(x), torch.from_numpy(txt))
    assert torch.equal(a, b)


def test_text_cache_features_train(tiny_state_factory):
    """Label embeddings from `TextFeatureCache` (computed under
    inference mode) go straight into a train step."""
    from lseg_tpu.testing import TINY_TEXT
    from lseg_tpu_torch.models.clip_text import CLIPTextEncoder
    from lseg_tpu_torch.text.cache import TextFeatureCache
    from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer

    text = random_init_(CLIPTextEncoder(TINY_TEXT),
                        torch.Generator().manual_seed(0))
    cache = TextFeatureCache(TINY_TEXT, text.state_dict(),
                             ClipBPETokenizer.for_tests(
                                 TINY_TEXT.context_length), device="cpu")
    txt = cache(["sky", "tree", "road", "other"])
    assert not txt.requires_grad
    make, _ = tiny_state_factory
    x, tgt, _ = _batch(2, seed=10)
    state, m = make_train_step()(
        make(), {"image": torch.from_numpy(x),
                 "target": torch.from_numpy(tgt).long()}, txt)
    assert np.isfinite(float(m["loss"])) and state.step == 1


def test_calibration_graph_free_and_int8_leaves_frozen():
    """`enable_grads` leaves the int8 codes, their scales and the act
    scales frozen; `calibrate_act_scales` then fills the act scales
    without a graph although the float leaves require grad."""
    from lseg_tpu_torch import fast_serving
    from lseg_tpu_torch.ops.quant import calibrate_act_scales, quantize_tree

    base = tiny_parity_config()
    x, _, txt = _batch(1, seed=11)
    sd = quantize_tree(from_jax_variables(jax_lseg_variables(base, x, txt)),
                       decoder=True, act_scale=True)
    model = LSegNet(fast_serving(base, "static_cal"), torch.bfloat16)
    model.load_state_dict(sd)
    enable_grads(model)
    params = dict(model.named_parameters())
    for name, p in params.items():
        leaf = name.rsplit(".", 1)[-1]
        assert p.requires_grad == (leaf not in ("weight_q", "scale",
                                                "act_scale")), name
    assert params["vit.blocks.0.norm1.weight"].requires_grad
    calibrate_act_scales(model, torch.from_numpy(x), None)
    scales = [p for n, p in params.items() if n.endswith("act_scale")]
    assert scales and all(float(p) != 1.0 and p.grad_fn is None
                          for p in scales)


def test_serving_stays_graph_free_with_trainable_params():
    from lseg_tpu_torch.engine.serve import make_predictor

    cfg = flashflat_config()
    x, _, txt = _batch(1, seed=9)
    model = enable_grads(random_init_(
        LSegNet(cfg, torch.float32, param_dtype=torch.float32),
        torch.Generator().manual_seed(0)))
    assert all(p.requires_grad for p in model.parameters())
    pred = make_predictor(model)(x, txt)
    assert pred.dtype == torch.int32 and not pred.requires_grad
    assert not model.training
