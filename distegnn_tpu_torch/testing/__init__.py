"""Fault injection for the serving layer (port of the serving half of
``distegnn_tpu/testing``; docs/ROBUSTNESS.md).

``serve_faults``: chaos injectors that kill, wedge, slow, SIGKILL or
SIGSTOP replicas, fail worker spawns and sabotage hot-swaps in a live
gateway. The training half (``faults``, ``tiny_run``) is not ported yet
(ROADMAP.md queue 1 item 9).
"""

from distegnn_tpu_torch.testing.serve_faults import (
    corrupt_checkpoint,
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
    "kill_replica",
    "kill9_replica",
    "sigstop_replica",
    "spawn_failure",
    "wedge_replica",
    "inject_execute_latency",
    "corrupt_swap_checkpoint",
]
