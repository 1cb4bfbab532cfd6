"""File + console logger (torch port of `lseg_tpu/utils/logging.py`), the
fewshot `Logger` equivalent
(reference: fewshot_data/common/logger.py:75-134): timestamped run
directory, mirrored stdout/file lines, arg dump, best-metric model
bookkeeping, and parameter counting. (The reference's tensorboardX /
wandb sinks are environment-gated extras there; here the durable sink
is the log file plus train/loop.py's metrics.csv.)
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional


class Logger:
    def __init__(self, logpath: str = "logs", name: Optional[str] = None):
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        self.dir = os.path.join(logpath, name or f"run_{stamp}")
        os.makedirs(self.dir, exist_ok=True)
        self._f = open(os.path.join(self.dir, "log.txt"), "a")
        self.best_miou = float("-inf")

    def info(self, msg: str) -> None:
        line = f"[{datetime.datetime.now():%H:%M:%S}] {msg}"
        print(line, flush=True)
        self._f.write(line + "\n")
        self._f.flush()

    def log_args(self, args: Any) -> None:
        self.info(":======== arguments ========:")
        for k, v in sorted(vars(args).items()):
            self.info(f"| {k}: {v}")
        self.info(":===========================:")

    def save_model_miou(self, save_fn, epoch: int, miou: float) -> bool:
        """Invoke save_fn(path) when `miou` improves on the best so far
        (reference: logger.py:116-121)."""
        if miou <= self.best_miou:
            return False
        self.best_miou = miou
        save_fn(os.path.join(self.dir, "best_model.npz"))
        self.info(f"model saved @{epoch} w/ val. mIoU: {miou:.2f}")
        return True

    @staticmethod
    def count_params(params) -> int:
        """Elements of a module's parameters, or of every tensor or array
        in a (nested) mapping such as a `state_dict`."""
        import numpy as np
        import torch

        if isinstance(params, torch.nn.Module):
            return sum(p.numel() for p in params.parameters())
        if isinstance(params, dict):
            return sum(Logger.count_params(v) for v in params.values())
        if torch.is_tensor(params):
            return params.numel()
        return int(np.size(params))
