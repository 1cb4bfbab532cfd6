"""The training loop (torch port of `lseg_tpu/train/loop.py`): resume
from the newest checkpoint at the epoch it recorded, one `set_epoch` per
epoch, validation pixAcc / mIoU with the eps-guarded mean, a checkpoint
after every epoch (last + best by val_acc), a CSV log and the metric
sinks (`utils.sinks`), and on SIGTERM / SIGUSR1 a
checkpoint at the end of the running epoch and a clean stop, so that a
preempted job resumes.

Data parallel (`group` of more than one rank): every rank runs `fit` on
its own loader shard through the data-parallel step; the validation sums
of all ranks are added before `meter.get()`. Only rank 0 logs and writes
the checkpoints, `metrics.csv` and the sinks; the other ranks wait at a
barrier before and after each save, so that a resume reads a finished
file, and a stop requested on any rank stops every rank after the epoch.
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from lseg_tpu_torch.parallel.dist import (
    all_reduce_,
    barrier,
    collective_device,
    rank,
    size,
)
from lseg_tpu_torch.utils.sinks import make_sinks
from lseg_tpu_torch.ops.metrics import SegmentationMetric
from lseg_tpu_torch.train.checkpoint import CheckpointManager
from lseg_tpu_torch.train.step import make_eval_step, make_train_step


@dataclass
class FitConfig:
    max_epochs: int = 240
    ignore_index: int = -1
    accumulate: int = 1
    log_every: int = 10
    ckpt_dir: str = "checkpoints/default"
    resume: bool = True
    val_every: int = 1
    tensorboard: bool = True
    wandb: bool = False
    exp_name: str = "lseg"


class CSVLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")
        self._header_written = os.path.getsize(path) > 0

    def log(self, row: dict):
        if not self._header_written:
            self._f.write(",".join(row.keys()) + "\n")
            self._header_written = True
        self._f.write(",".join(str(v) for v in row.values()) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def _sum_over_ranks(meter: SegmentationMetric, group) -> None:
    """Replace `meter`'s sums by their sums over the ranks."""
    if size(group) == 1:
        return
    t = torch.from_numpy(np.concatenate([
        [meter.total_correct, meter.total_label], meter.total_inter,
        meter.total_union]))
    t = t.to(collective_device(group))
    all_reduce_([t], group)
    t = t.cpu().numpy()
    k = meter.nclass
    meter.total_correct, meter.total_label = float(t[0]), float(t[1])
    meter.total_inter, meter.total_union = t[2:2 + k], t[2 + k:]


def fit(state, train_loader, text_features, cfg: FitConfig,
        val_loader=None, nclass: Optional[int] = None,
        log: Callable[[str], None] = print, group=None):
    """Run the schedule from the resumed epoch to `cfg.max_epochs`;
    returns the state (updated in place). With a `group`, each rank's
    loaders hold its shard."""
    is_main = rank(group) == 0
    if not is_main:
        log = _silent
    train_step = make_train_step(cfg.ignore_index, cfg.accumulate, group)
    eval_step = make_eval_step(cfg.ignore_index)
    if is_main:
        ckpt = CheckpointManager(cfg.ckpt_dir)
        csv = CSVLogger(os.path.join(cfg.ckpt_dir, "metrics.csv"))
        sinks = make_sinks(cfg.ckpt_dir, exp_name=cfg.exp_name,
                           tensorboard=cfg.tensorboard, wandb=cfg.wandb)
    barrier(group)
    if not is_main:
        ckpt, csv, sinks = CheckpointManager(cfg.ckpt_dir), None, None

    start_epoch = 0
    if cfg.resume and ckpt.restore(state) is not None:
        saved = (ckpt.latest_metrics() or {}).get("epoch")
        if saved is not None:
            start_epoch = int(saved) + 1
        else:
            start_epoch = state.step // max(len(train_loader), 1)
        log(f"resumed from step {state.step} (epoch {start_epoch})")

    stop_requested = {"flag": False}

    def _request_stop(signum, frame):
        stop_requested["flag"] = True
        log(f"signal {signum}: will checkpoint and stop")

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGUSR1):
        try:
            prev_handlers[sig] = signal.signal(sig, _request_stop)
        except (ValueError, OSError):  # not the main thread
            pass

    try:
        for epoch in range(start_epoch, cfg.max_epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            t0 = time.time()
            last_loss = float("nan")
            n_steps = 0
            for batch in train_loader:
                state, metrics = train_step(state, batch, text_features)
                n_steps += 1
                # read the loss (a device sync) only at log points
                if n_steps % cfg.log_every == 0:
                    last_loss = float(metrics["loss"])
                    log(f"epoch {epoch} step {n_steps} loss {last_loss:.4f}")
            epoch_time = time.time() - t0
            row = {"epoch": epoch, "loss": last_loss,
                   "epoch_time_s": round(epoch_time, 2), "val_acc": "",
                   "val_miou": ""}
            if val_loader is not None and (epoch + 1) % cfg.val_every == 0:
                meter = SegmentationMetric(
                    nclass or int(text_features.shape[0]), cfg.ignore_index)
                for batch in val_loader:
                    m = eval_step(state, batch, text_features)
                    meter.add(m["correct"], m["labeled"], m["inter"],
                              m["union"])
                _sum_over_ranks(meter, group)
                val_acc, val_miou = meter.get()
                row["val_acc"], row["val_miou"] = val_acc, val_miou
                log(f"epoch {epoch} val pixAcc {val_acc:.4f} "
                    f"mIoU {val_miou:.4f} ({epoch_time:.1f}s)")
                saved = {"val_acc": val_acc, "val_miou": val_miou,
                         "epoch": float(epoch)}
            else:
                saved = {"epoch": float(epoch)}
            barrier(group)
            if is_main:
                ckpt.save(state.step, state, saved)
                csv.log(row)
                sinks.scalars(epoch, {k: v for k, v in row.items()
                                      if k != "epoch" and v != "" and v == v})
            barrier(group)
            if _any_rank(stop_requested["flag"], group):
                log(f"stopping after epoch {epoch} (preemption)")
                break
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        if is_main:
            csv.close()
            sinks.close()
    return state


def _silent(msg: str) -> None:
    pass


def _any_rank(flag: bool, group) -> bool:
    """Whether `flag` is set on any rank (every rank gets the answer)."""
    if size(group) == 1:
        return flag
    t = torch.tensor([int(flag)], device=collective_device(group))
    all_reduce_([t], group)
    return bool(t.item())
