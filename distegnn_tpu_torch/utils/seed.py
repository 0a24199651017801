"""Seeding (port of ``distegnn_tpu/utils/seed.py``).

``fix_seed`` seeds the host generators (Python, numpy) and torch's default
generators. Randomness inside a training step does not come from them: it
comes from explicit ``torch.Generator``s seeded from (seed, epoch, step)
(``train/step.py``), as the JAX package folds its PRNG key.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def fix_seed(seed: int = 43) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
