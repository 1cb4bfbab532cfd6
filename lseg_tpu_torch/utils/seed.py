"""Determinism helper (torch port of `lseg_tpu/utils/seed.py`): the
reference seeds torch, numpy and `random` before the episodic protocol
(fewshot_data/common/utils.py:8-17, test_lseg_zs.py:288). Here the
host-side RNGs (episode sampling, augmentation) are seeded and an
explicit `torch.Generator` is returned in place of the JAX package's root
key: the port draws its random tensors from a generator it is given,
never from torch's global one."""

from __future__ import annotations

import random

import numpy as np
import torch


def fix_randseed(seed: int) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
