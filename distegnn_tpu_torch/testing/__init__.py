"""Deterministic fault injection for the resilience layer (port of
``distegnn_tpu/testing``; docs/ROBUSTNESS.md).

Everything here is test machinery: injectors that corrupt checkpoints, poison
batches, and fail file opens on demand (``faults``), serving chaos injectors
that kill/wedge replicas and sabotage hot-swaps in a live gateway
(``serve_faults``), the promotion conveyor's drill (``promote_drill``), plus
a tiny subprocess training entry point (``tiny_run``) the kill-and-resume
tests drive.
"""

from distegnn_tpu_torch.testing.faults import (
    corrupt_checkpoint,
    flaky_open,
    inject_at_call,
    poison_nan_batches,
    simulate_killed_save,
    truncated_read,
)
from distegnn_tpu_torch.testing.serve_faults import (
    corrupt_swap_checkpoint,
    inject_execute_latency,
    kill9_replica,
    kill_replica,
    sigstop_replica,
    spawn_failure,
    wedge_replica,
)

__all__ = [
    "corrupt_checkpoint",
    "simulate_killed_save",
    "poison_nan_batches",
    "flaky_open",
    "truncated_read",
    "inject_at_call",
    "kill_replica",
    "kill9_replica",
    "sigstop_replica",
    "spawn_failure",
    "wedge_replica",
    "inject_execute_latency",
    "corrupt_swap_checkpoint",
]
