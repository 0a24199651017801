"""One intra-op thread for torch in the port's CPU tests.

The suite runs under pytest-xdist, several worker processes on the
machine's cores; torch's default of one intra-op thread per core in every
worker oversubscribes them several times over, and the port's tests then
spend most of their time waiting for cores. Every ``tests/test_torch_*.py``
module imports this one (xdist workers import every test module when they
collect, so the setting holds for the whole run)."""

import torch

torch.set_num_threads(1)
