"""The port's data parallelism against the JAX package's (`lseg_tpu/
parallel`, the sharded predictors and evaluator, the multi-process loader
and the global-view train step), on the CPU with two gloo ranks.

The two ranks run once for the module (`tests/torch_parallel_worker.py`,
a file store in a temporary directory, so concurrent test workers never
share a port); each case below reads their results. The JAX side runs in
this process on the conftest's virtual CPU devices: the inputs are made
from seeds with numpy and the port's seeded weights are carried into the
JAX tree (`torch_parity.seeded_variables`).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parallel_worker import (
    TTA_PROTOCOL,
    IndexDataset,
    int8_config,
)
from torch_parity import seeded_variables

from lseg_tpu.testing import tiny_vit_config as j_tiny_vit_config
from lseg_tpu_torch.models.layers import BatchNorm, random_init_
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.ops.quant import calibrate_act_scales, quantize_tree
from lseg_tpu_torch.parallel import (
    batch_shard,
    create_mesh,
    init_distributed,
    rank_rows,
)
from lseg_tpu_torch.testing import tiny_vit_config
from lseg_tpu_torch.utils.convert import from_jax_variables, to_jax_variables

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
WORLD = 2
# ignored share of each image's rows in the train batch: rank 0 holds
# rows 0-1 (accumulate 1) or 0 and 2 (accumulate 2), so the two ranks
# hold different numbers of ignored pixels either way
IGNORE_SHARE = (0.5, 0.0, 0.3, 0.05)


def _int8_tree(x, txt):
    """The static_cal tiny model's tree, quantized and calibrated by the
    port (seeded weights, the xla attention of the fp32 twin)."""
    cfg = int8_config(tiny_vit_config())
    cfg0 = dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, attn_impl="xla", quant_int8=False, patch_fused=False),
        decoder_quant=False)
    ref = random_init_(LSegNet(cfg0), torch.Generator().manual_seed(3))
    model = LSegNet(cfg, torch.bfloat16)
    model.load_state_dict(quantize_tree(ref.state_dict(), decoder=True,
                                        act_scale=True))
    calibrate_act_scales(model, torch.from_numpy(x), torch.from_numpy(txt))
    return model.state_dict()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    v = seeded_variables(j_tiny_vit_config())
    x = rng.randn(4, 64, 64, 3).astype(np.float32)
    tgt = rng.randint(0, 4, (4, 64, 64)).astype(np.int32)
    for i, share in enumerate(IGNORE_SHARE):
        tgt[i, :int(64 * share)] = -1
    txt = rng.randn(4, 64).astype(np.float32)
    xq = rng.randn(4, 64, 64, 3).astype(np.float32)
    bn_var = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    arrays = {
        "x": x, "tgt": tgt, "txt": txt, "xq": xq,
        "x1": rng.randn(2, 64, 64, 3).astype(np.float32),
        "txt64": rng.randn(64, 64).astype(np.float32),
        "ev_x": rng.randn(4, 64, 64, 3).astype(np.float32),
        "ev_tgt": rng.randint(-1, 4, (4, 64, 64)).astype(np.int32),
        "tta_image": rng.randn(80, 100, 3).astype(np.float32),
        "bn_x": rng.randn(4, 5, 5, 8).astype(np.float32),
        "bn_w": rng.randn(4, 5, 5, 8).astype(np.float32)}
    bn_state = {"weight": rng.randn(8), "bias": rng.randn(8),
                "running_mean": rng.randn(8), "running_var": bn_var}
    tiny_q = _int8_tree(xq, txt)
    return {"v": v, "np": arrays, "tiny_q": tiny_q, "torch": {
        **{k: torch.from_numpy(a) for k, a in arrays.items()},
        "tgt": torch.from_numpy(tgt).long(),
        "bn_state": {k: torch.from_numpy(np.asarray(a, np.float32))
                     for k, a in bn_state.items()},
        "tiny": from_jax_variables(v), "tiny_q": tiny_q}}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Both ranks' results (one run for the module)."""
    d = tmp_path_factory.mktemp("parallel")
    torch.save(inputs["torch"], d / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="2")
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


# --- single process: the helpers without a group -----------------------


def test_one_process_is_not_distributed(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert init_distributed() is None
    assert create_mesh() is None
    x = torch.arange(6)
    assert batch_shard(x, None) is x
    with pytest.raises(NotImplementedError, match="A10b"):
        create_mesh(n_data=4, n_model=2)


def test_rank_rows_form_the_global_micro_batches():
    assert rank_rows(8, 1, 2).tolist() == [4, 5, 6, 7]
    assert rank_rows(8, 0, 2, 2).tolist() == [0, 1, 4, 5]
    assert rank_rows(8, 1, 2, 2).tolist() == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="must divide"):
        rank_rows(6, 0, 2, 2)


# --- two ranks ----------------------------------------------------------


def test_loader_shards_equal_jax_streams(ranks):
    """accumulate 1: each rank's batches equal the JAX loader's with
    process_count 2, process_index r; accumulate 2: the ranks' local
    micro-batches side by side are the global batch's micro-batches,
    the global batch being the JAX processes' batches one after
    another."""
    from lseg_tpu.data.loader import DataLoader as JDataLoader

    def jax_batches(bs, r, epoch):
        dl = JDataLoader(IndexDataset(), bs, num_workers=2, process_count=2,
                         process_index=r)
        dl.set_epoch(epoch)
        return [b["target"][:, 0, 0].tolist() for b in dl]

    for epoch in (0, 3):
        shards = [ranks[r]["loader"][1, epoch] for r in range(WORLD)]
        for r in range(WORLD):
            assert shards[r] == jax_batches(2, r, epoch)
        seen = [i for s in shards for b in s for i in b]
        assert len(seen) == len(set(seen)) == 16
        glob = [sum(bs, []) for bs in zip(*(jax_batches(4, r, epoch)
                                            for r in range(WORLD)))]
        local = [ranks[r]["loader"][2, epoch] for r in range(WORLD)]
        assert len(glob) == len(local[0]) == 2
        for b, g in enumerate(glob):
            for i in range(2):
                micro = sum((local[r][b][2 * i:2 * i + 2]
                             for r in range(WORLD)), [])
                assert micro == g[4 * i:4 * i + 4]


def test_synced_batchnorm_matches_one_process(ranks, inputs):
    """3 + 1 rows over two ranks against one process over the 4 rows:
    output, input and parameter gradients (summed over the ranks) and
    the running statistics of both ranks."""
    t = inputs["torch"]
    bn = BatchNorm(8)
    bn.load_state_dict(t["bn_state"])
    bn.weight.requires_grad_(True)
    bn.bias.requires_grad_(True)
    x = t["bn_x"].clone().requires_grad_(True)
    bn.train()
    y = bn(x)
    (y * t["bn_w"]).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    got = [r["bn"] for r in ranks]
    for name, ref in (("y", y.detach()), ("x_grad", x.grad)):
        np.testing.assert_allclose(torch.cat([g[name] for g in got]).numpy(),
                                   ref.numpy(), err_msg=name, **tol)
    for name, ref in (("weight_grad", bn.weight.grad),
                      ("bias_grad", bn.bias.grad)):
        np.testing.assert_allclose(sum(g[name] for g in got).numpy(),
                                   ref.numpy(), err_msg=name, **tol)
    for g in got:
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(g[name].numpy(),
                                       getattr(bn, name).numpy(),
                                       err_msg=name, **tol)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_parallel_train_step_matches_jax(ranks, inputs, accumulate):
    """Two ranks whose rows hold different numbers of ignored pixels
    against JAX's `make_train_step` on one device over the global batch.
    At accumulate 2 rank r holds rows (2r, 2r + 1) of each global
    micro-batch (`rank_rows`), so JAX gets the global batch in its own
    row order: its micro-batch i is rows [2i, 2i + 2). Tolerances of
    `test_sharded_train_step_matches_single_device`; the ranks' states
    are equal bit for bit."""
    from lseg_tpu.models.lseg import LSegNet as JLSegNet
    from lseg_tpu.train import create_train_state
    from lseg_tpu.train import make_optimizer as jmake_optimizer
    from lseg_tpu.train import make_train_step as jmake_train_step

    a = inputs["np"]
    state = create_train_state(JLSegNet(j_tiny_vit_config()), inputs["v"],
                               jmake_optimizer(0.01, 100, batch_size=4))
    new, m = jax.jit(jmake_train_step(-1, accumulate))(
        state, {"image": jnp.asarray(a["x"]), "target": jnp.asarray(a["tgt"])},
        jnp.asarray(a["txt"]))
    ref = from_jax_variables({"params": new.params,
                              "batch_stats": new.batch_stats})
    got = [r["train"][accumulate] for r in ranks]
    assert got[0]["labeled"] == got[1]["labeled"] == int(m["labeled"])
    assert got[0]["correct"] == int(m["correct"])
    for g in got:
        np.testing.assert_allclose(g["loss"], float(m["loss"]), rtol=1e-5)
    for name, r in ref.items():
        np.testing.assert_array_equal(got[0]["state"][name].numpy(),
                                      got[1]["state"][name].numpy(),
                                      err_msg=name)
        np.testing.assert_allclose(got[0]["state"][name].numpy(), r.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_labelset_sharded_predictor_equals_jax_exactly(ranks, inputs):
    """K = 64 over two ranks (32 labels each) against JAX's unsharded
    `make_predictor`, every pixel; with the same 32 labels on both ranks
    every pixel ties across them and the lowest index wins (JAX's labels
    over those 32); K = 63 raises."""
    from lseg_tpu.engine.serve import make_predictor as j_make_predictor
    from lseg_tpu.models.lseg import LSegNet as JLSegNet

    a = inputs["np"]
    jpred = j_make_predictor(JLSegNet(j_tiny_vit_config()), inputs["v"])
    ref = np.asarray(jpred(jnp.asarray(a["x1"]), jnp.asarray(a["txt64"])))
    ref32 = np.asarray(jpred(jnp.asarray(a["x1"]),
                             jnp.asarray(a["txt64"][:32])))
    for r in ranks:
        out = r["labelset"]
        assert out["labels"].dtype == torch.int32
        np.testing.assert_array_equal(out["labels"].numpy(), ref)
        np.testing.assert_array_equal(out["unsharded"].numpy(), ref)
        np.testing.assert_array_equal(out["tied"].numpy(), ref32)
        assert "must divide" in out["k63"]


def test_data_sharded_predictor(ranks, inputs):
    """The static_cal tiny model (width 128, two heads): the gathered map
    is the ranks' own per-shard calls side by side, bit for bit, on both
    ranks; against JAX's `make_data_sharded_predictor` on two devices by
    the port's int8 label rule (`test_int8_argmax_matches_jitted_batch1`:
    >= 0.985 of the pixels); a batch of 3 raises."""
    from jax.sharding import Mesh

    from lseg_tpu.config import fast_serving
    from lseg_tpu.engine.serve import make_data_sharded_predictor as jpred
    from lseg_tpu.models.lseg import LSegNet as JLSegNet

    local = torch.cat([r["data_sharded"]["local"] for r in ranks])
    for r in ranks:
        out = r["data_sharded"]
        np.testing.assert_array_equal(out["labels"].numpy(), local.numpy())
        assert "must divide" in out["n3"]
    base = j_tiny_vit_config()
    cfg = fast_serving(dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, embed_dim=128, num_heads=2)), quant="static_cal")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        int8_config(tiny_vit_config()))
    vq = to_jax_variables(inputs["tiny_q"], cfg.vit.hooks)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    a = inputs["np"]
    ref = np.asarray(jpred(JLSegNet(cfg, dtype=jnp.bfloat16), vq, mesh)(
        jnp.asarray(a["xq"]), jnp.asarray(a["txt"])))
    agree = float(np.mean(local.numpy() == ref))
    assert agree >= 0.985, agree


def test_sharded_single_scale_evaluator_equals_unsharded(ranks):
    """Flip TTA at batch 4 over two ranks: the gathered labels and the
    all-reduced metric sums equal the unsharded evaluator's exactly."""
    for r in ranks:
        ev = r["evaluator"]
        np.testing.assert_array_equal(ev["labels"].numpy(),
                                      ev["labels0"].numpy())
        for got, ref in zip(ev["metrics"], ev["metrics0"]):
            np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_sharded_tta_label_map_equals_unsharded(ranks):
    """The 3-scale + flip protocol with the crop batch of 8 split over
    two ranks (`make_data_sharded_logits_fn`) equals the unsharded label
    map exactly, as `test_sharded_tta_eval_matches_single_device`."""
    assert TTA_PROTOCOL.flip
    for r in ranks:
        ev = r["evaluator"]
        np.testing.assert_array_equal(ev["tta"].numpy(), ev["tta0"].numpy())


def _csv_rows(text):
    header, *rows = [line.split(",") for line in text.splitlines()]
    return [dict(zip(header, row)) for row in rows]


def test_fit_sums_validation_over_ranks(ranks):
    """Epoch 0's validation pixAcc and mIoU in rank 0's metrics.csv, each
    rank having scored its own batch, equal one process's `fit` over both
    batches from the same state."""
    got = _csv_rows(ranks[0]["fit"]["csv"])[0]
    ref = _csv_rows(ranks[0]["fit"]["csv_one_process"])[0]
    assert got["epoch"] == ref["epoch"] == "0"
    for key in ("val_acc", "val_miou"):
        assert float(got[key]) == float(ref[key]), key


def test_fit_stops_and_resumes_on_every_rank(ranks):
    """A stop requested on rank 1 alone ends epoch 0 on both ranks (1 step
    of 3 epochs); the resumed run starts both ranks at epoch 1 from rank
    0's checkpoint and their states stay equal; rank 0 alone saved, and
    metrics.csv holds one header and one row an epoch."""
    a, b = ranks[0]["fit"], ranks[1]["fit"]
    assert a["steps"] == b["steps"] == [1, 2]
    assert a["saves"] == [1, 2] and b["saves"] == []
    assert a["csv"] == b["csv"]
    assert [row["epoch"] for row in _csv_rows(a["csv"])] == ["0", "1"]
    for name, t in a["state"].items():
        np.testing.assert_array_equal(t.numpy(), b["state"][name].numpy(),
                                      err_msg=name)
