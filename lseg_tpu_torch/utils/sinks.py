"""Metric sinks — the reference's experiment-tracking surface.

The reference logs through three channels: a TestTube/TensorboardX
writer (fewshot_data/common/logger.py:95-113), a wandb logger with a
persisted run id so auto-resumed jobs continue the same run
(utils.py:36-43,171-197), and plain files. Here each is a small sink
with one `scalars(step, {name: value})` method behind a multiplexer;
unavailable backends degrade to no-ops at construction (wandb is not in
this image), so training code never branches.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional


class TensorBoardSink:
    """tensorboardX SummaryWriter sink (reference Logger.tbd_writer,
    fewshot_data/common/logger.py:95-113). No-op if tensorboardX is
    unavailable."""

    def __init__(self, logdir: str):
        try:
            from tensorboardX import SummaryWriter

            self._w = SummaryWriter(logdir)
        except ImportError:
            self._w = None

    @property
    def active(self) -> bool:
        return self._w is not None

    def scalars(self, step: int, metrics: Dict[str, float]) -> None:
        if self._w is None:
            return
        for k, v in metrics.items():
            self._w.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        if self._w is not None:
            self._w.close()


class WandbSink:
    """wandb sink with the reference's persisted-run-id resume semantics
    (utils.py:171-197: the run id is written next to the checkpoints so
    an auto-resumed job continues the same wandb run). No-op if wandb is
    unavailable or disabled."""

    def __init__(self, project: str, exp_name: str, run_dir: str,
                 enabled: bool = True):
        self._run = None
        if not enabled:
            return
        try:
            import wandb
        except ImportError:
            return
        os.makedirs(run_dir, exist_ok=True)
        id_file = os.path.join(run_dir, "wandb_id.txt")
        if os.path.exists(id_file):
            with open(id_file) as f:
                run_id = f.read().strip()
            resume = "allow"
        else:
            run_id = wandb.util.generate_id()
            with open(id_file, "w") as f:
                f.write(run_id)
            resume = None
        self._run = wandb.init(project=project, name=exp_name,
                               id=run_id, resume=resume)

    @property
    def active(self) -> bool:
        return self._run is not None

    def scalars(self, step: int, metrics: Dict[str, float]) -> None:
        if self._run is None:
            return
        self._run.log({k: float(v) for k, v in metrics.items()},
                      step=int(step))

    def close(self) -> None:
        if self._run is not None:
            self._run.finish()


class MetricSinks:
    """Fan-out multiplexer over any objects with scalars()/close()."""

    def __init__(self, sinks: Optional[List] = None):
        self.sinks = list(sinks or [])

    def scalars(self, step: int, metrics: Dict[str, float]) -> None:
        for s in self.sinks:
            s.scalars(step, metrics)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def make_sinks(run_dir: str, exp_name: str = "lseg",
               project: str = "lseg_tpu", tensorboard: bool = True,
               wandb: bool = True) -> MetricSinks:
    """The reference's dual-logger setup (utils.py:36-43): TB + wandb,
    each degrading to a no-op when its backend is absent."""
    sinks: List = []
    if tensorboard:
        tb = TensorBoardSink(os.path.join(run_dir, "tb"))
        if tb.active:
            sinks.append(tb)
    if wandb:
        wb = WandbSink(project, exp_name, run_dir, enabled=True)
        if wb.active:
            sinks.append(wb)
    return MetricSinks(sinks)
