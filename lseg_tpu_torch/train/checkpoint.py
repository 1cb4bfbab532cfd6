"""Checkpoint save and resume (torch port of
`lseg_tpu/train/checkpoint.py`).

Each checkpoint is `ckpt_<step>.pt` (`torch.save` of the step count, the
model's `state_dict` with its BatchNorm statistics, and the optimizer's
state) with its metrics beside it in `ckpt_<step>.json` (`fit` records
the epoch there). Both are written to a temporary file and moved into
place with `os.replace`, the metrics first, so a checkpoint file never
exists half written or without its metrics. The newest checkpoint is
always kept, and beside it the best MAX_TO_KEEP by BEST_METRIC (a
missing metric counts as 0, ties go to the newer).
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import List, Optional

import torch

_NAME = re.compile(r"ckpt_(\d+)\.pt")
MAX_TO_KEEP = 3
BEST_METRIC = "val_acc"


class CheckpointManager:
    def __init__(self, directory: str):
        self.dir = Path(directory).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, step: int, suffix: str) -> Path:
        return self.dir / f"ckpt_{step:010d}{suffix}"

    @staticmethod
    def _write(path: Path, write) -> None:
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        write(tmp)
        os.replace(tmp, path)

    def steps(self) -> List[int]:
        """Steps with a complete checkpoint, oldest first."""
        return sorted(int(m.group(1)) for m in map(
            _NAME.fullmatch, os.listdir(self.dir)) if m)

    def save(self, step: int, state, metrics: Optional[dict] = None) -> None:
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        self._write(self._path(step, ".json"),
                    lambda p: p.write_text(json.dumps(metrics)))
        payload = {"step": int(state.step),
                   "model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict()}
        self._write(self._path(step, ".pt"),
                    lambda p: torch.save(payload, p))
        self._prune()

    def _prune(self) -> None:
        steps = self.steps()
        if not steps:
            return
        best = sorted(steps, key=lambda s: (self.metrics(s).get(
            BEST_METRIC, 0.0), s), reverse=True)[:MAX_TO_KEEP]
        keep = set(best) | {steps[-1]}
        for s in steps:
            if s not in keep:
                for suffix in (".pt", ".json"):
                    self._path(s, suffix).unlink(missing_ok=True)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> dict:
        path = self._path(step, ".json")
        return json.loads(path.read_text()) if path.exists() else {}

    def latest_metrics(self) -> Optional[dict]:
        step = self.latest_step()
        return None if step is None else self.metrics(step)

    def restore(self, state):
        """Load the newest checkpoint into `state` (model, optimizer and
        step count, in place); returns it, or None if there is none."""
        step = self.latest_step()
        if step is None:
            return None
        device = next(state.model.parameters()).device
        payload = torch.load(self._path(step, ".pt"), map_location=device,
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state
