"""One rank of the port's data-parallel CPU checks (`tests/
test_torch_parallel.py`): gloo over a file store, the port only (no JAX).

    python tests/torch_parallel_worker.py RANK WORLD INIT_FILE DIR

Reads `DIR/inputs.pt` (seeded inputs and state_dicts the test wrote),
runs every case on this rank and writes `DIR/out_<RANK>.pt`: the loader's
index streams, the synced BatchNorm, the data-parallel train step at
accumulate 1 and 2, the label-set- and data-sharded predictors, the
sharded single-scale and TTA evaluators and the training loop, each
beside the unsharded call where the test holds them to it.
"""

import dataclasses
import os
import signal
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lseg_tpu_torch.config import fast_serving  # noqa: E402
from lseg_tpu_torch.data.loader import DataLoader  # noqa: E402
from lseg_tpu_torch.engine.eval_single import SingleScaleEvaluator  # noqa: E402
from lseg_tpu_torch.engine.serve import (  # noqa: E402
    make_data_sharded_logits_fn,
    make_data_sharded_predictor,
    make_labelset_sharded_predictor,
    make_logits_fn,
    make_predictor,
)
from lseg_tpu_torch.engine.tta import MultiScaleEvaluator, TTAProtocol  # noqa: E402
from lseg_tpu_torch.models.layers import BatchNorm, random_init_  # noqa: E402
from lseg_tpu_torch.models.lseg import LSegNet  # noqa: E402
from lseg_tpu_torch.ops.quant import (  # noqa: E402
    calibrate_act_scales,
    quantize_tree,
)
from lseg_tpu_torch.parallel import (  # noqa: E402
    batch_shard,
    create_mesh,
    init_distributed,
    rank_rows,
    sync_batchnorm_,
)
from lseg_tpu_torch.testing import tiny_vit_config  # noqa: E402
from lseg_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from lseg_tpu_torch.train.loop import FitConfig, fit  # noqa: E402
from lseg_tpu_torch.train.optim import make_optimizer  # noqa: E402
from lseg_tpu_torch.train.step import (  # noqa: E402
    TrainState,
    enable_grads,
    make_train_step,
)

# the loader case: 17 samples, batch 2 a rank (accumulate 2: 4 a rank)
LOADER_N = 17
TTA_PROTOCOL = TTAProtocol(base_size=72, crop_size=64, scales=(0.5, 1.0, 1.5),
                           flip=True)


def int8_config(base):
    """`base` at width 128 with two heads under `fast_serving(...,
    'static_cal')`: the data-sharded serving test's config (either
    package's `base`)."""
    return fast_serving(dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, embed_dim=128, num_heads=2)), quant="static_cal")


def int8_tree(x, txt):
    """The static_cal tree of `int8_config(tiny_vit_config())`, quantized
    and calibrated by the port on numpy inputs `x`, `txt` (seeded weights,
    the xla attention of the fp32 twin)."""
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


class IndexDataset:
    """Sample i carries i in its image and target."""

    def __len__(self):
        return LOADER_N

    def __getitem__(self, i):
        return {"image": np.full((1, 1, 3), i, np.float32),
                "target": np.full((1, 1), i, np.int32)}


def loader_case(r, w):
    out = {}
    for acc, bs in ((1, 2), (2, 4)):
        dl = DataLoader(IndexDataset(), bs, num_workers=2, device="cpu",
                        process_count=w, process_index=r, accumulate=acc)
        for epoch in (0, 3):
            dl.set_epoch(epoch)
            out[acc, epoch] = [b["target"][:, 0, 0].tolist() for b in dl]
    return out


def bn_case(inp, group, r):
    bn = BatchNorm(8)
    bn.load_state_dict(inp["bn_state"])
    bn.weight.requires_grad_(True)
    bn.bias.requires_grad_(True)
    sync_batchnorm_(bn, group)
    rows = slice(0, 3) if r == 0 else slice(3, 4)  # uneven on purpose
    x = inp["bn_x"][rows].clone().requires_grad_(True)
    bn.train()
    y = bn(x)
    (y * inp["bn_w"][rows]).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}


class Preempted(list):
    """A loader that sends SIGUSR1 to its own process as its epoch
    starts: a preemption notice that reaches one rank only."""

    def __iter__(self):
        os.kill(os.getpid(), signal.SIGUSR1)
        return super().__iter__()


def tiny_state(tree):
    model = LSegNet(tiny_vit_config(), torch.float32, remat=True,
                    param_dtype=torch.float32)
    model.load_state_dict(tree)
    enable_grads(model)
    return TrainState(model, make_optimizer(model, 0.01, 100, batch_size=4))


def train_case(inp, group, r, w, acc):
    state = tiny_state(inp["tiny"])
    model = state.model
    rows = rank_rows(inp["x"].shape[0], r, w, acc)
    batch = {"image": inp["x"][rows], "target": inp["tgt"][rows]}
    state, m = make_train_step(-1, acc, group)(state, batch, inp["txt"])
    return {"loss": float(m["loss"]), "labeled": int(m["labeled"]),
            "correct": int(m["correct"]), "inter": m["inter"],
            "union": m["union"], "state": {
                k: v.detach().clone() for k, v in model.state_dict().items()}}


def labelset_case(inp, group):
    model = LSegNet(tiny_vit_config())
    pred = make_labelset_sharded_predictor(model, inp["tiny"], group)
    half = inp["txt64"][:32]
    out = {"labels": pred(inp["x1"], inp["txt64"]),
           "unsharded": make_predictor(model)(inp["x1"], inp["txt64"]),
           "tied": pred(inp["x1"], torch.cat([half, half]))}
    try:
        pred(inp["x1"], inp["txt64"][:63])
    except ValueError as e:
        out["k63"] = str(e)
    return out


def data_sharded_case(inp, group):
    model = LSegNet(int8_config(tiny_vit_config()), torch.bfloat16)
    pred = make_data_sharded_predictor(model, inp["tiny_q"], group)
    with torch.inference_mode():
        local = model(batch_shard(inp["xq"], group), inp["txt"],
                      return_argmax=True)
    out = {"labels": pred(inp["xq"], inp["txt"]), "local": local}
    try:
        pred(inp["xq"][:3], inp["txt"])
    except ValueError as e:
        out["n3"] = str(e)
    return out


def evaluator_case(inp, group):
    model = LSegNet(tiny_vit_config())
    fn = make_logits_fn(model, inp["tiny"])
    sharded = SingleScaleEvaluator(fn, 4, flip=True, group=group)
    whole = SingleScaleEvaluator(fn, 4, flip=True)
    img, tgt, txt = inp["ev_x"], inp["ev_tgt"], inp["txt"]
    tta = MultiScaleEvaluator(make_data_sharded_logits_fn(model, None, group),
                              4, TTA_PROTOCOL)
    tta0 = MultiScaleEvaluator(fn, 4, TTA_PROTOCOL)
    return {"labels": sharded(img, txt), "labels0": whole(img, txt),
            "metrics": sharded.metrics(img, tgt, txt),
            "metrics0": whole.metrics(img, tgt, txt),
            "tta": tta(inp["tta_image"], txt),
            "tta0": tta0(inp["tta_image"], txt)}


def fit_case(inp, group, r, w, out_dir):
    """`fit` on two ranks, one train batch and one validation batch a rank
    an epoch: (A) up to 3 epochs with a stop requested on rank 1 alone
    during epoch 0, (B) a fresh state resumed from A's checkpoint up to 2
    epochs. Rank 0 then runs one-process `fit` (no group, no train batch)
    from its state after A over both ranks' validation batches: the
    metrics.csv row the test holds A's epoch-0 validation to. Each rank
    records the steps it saved at."""
    saves = []
    save = CheckpointManager.save

    def counted_save(self, step, state, metrics=None):
        saves.append(step)
        save(self, step, state, metrics)

    CheckpointManager.save = counted_save
    val = [{"image": inp["ev_x"][rows], "target": inp["ev_tgt"][rows].long()}
           for rows in (rank_rows(4, q, w) for q in range(w))]
    rows = rank_rows(4, r, w)
    train = [{"image": inp["x"][rows], "target": inp["tgt"][rows]}]
    cfg = FitConfig(max_epochs=3, log_every=1, ckpt_dir=str(out_dir / "fit"),
                    tensorboard=False, wandb=False)
    state = fit(tiny_state(inp["tiny"]), Preempted(train) if r else train,
                inp["txt"], cfg, val_loader=[val[r]], group=group)
    steps = [state.step]
    after_a = {k: v.detach().clone()
               for k, v in state.model.state_dict().items()}
    state = fit(tiny_state(inp["tiny"]), train, inp["txt"],
                dataclasses.replace(cfg, max_epochs=2), val_loader=[val[r]],
                group=group)
    steps.append(state.step)
    out = {"saves": saves, "steps": steps,
           "csv": (out_dir / "fit" / "metrics.csv").read_text(),
           "state": {k: v.detach().clone()
                     for k, v in state.model.state_dict().items()}}
    CheckpointManager.save = save
    if r == 0:
        ref_dir = out_dir / "fit_one_process"
        fit(tiny_state(after_a), [], inp["txt"], dataclasses.replace(
            cfg, max_epochs=1, ckpt_dir=str(ref_dir), resume=False),
            val_loader=val)
        out["csv_one_process"] = (ref_dir / "metrics.csv").read_text()
    return out


def main():
    r, w, init, out_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           Path(sys.argv[4]))
    torch.set_num_threads(2)
    group = init_distributed(f"file://{init}", w, r, backend="gloo")
    assert create_mesh() is group
    inp = torch.load(out_dir / "inputs.pt", weights_only=False)
    res = {"loader": loader_case(r, w), "bn": bn_case(inp, group, r),
           "train": {acc: train_case(inp, group, r, w, acc)
                     for acc in (1, 2)},
           "labelset": labelset_case(inp, group),
           "data_sharded": data_sharded_case(inp, group),
           "evaluator": evaluator_case(inp, group),
           "fit": fit_case(inp, group, r, w, out_dir)}
    torch.save(res, out_dir / f"out_{r}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
