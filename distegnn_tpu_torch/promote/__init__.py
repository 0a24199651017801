"""Continuous train->serve promotion conveyor (port of
``distegnn_tpu/promote``; docs/SERVING.md "Continuous promotion").

The trainer end publishes every rotated checkpoint as a *candidate* —
``step_<n>.ckpt`` plus a JSON manifest — into a watched directory
(:mod:`distegnn_tpu_torch.promote.publish`). The serving end runs a control
loop (:mod:`distegnn_tpu_torch.promote.promoter`) that canaries each new
candidate on one quarantined replica, replays a shadow sample of live
traffic against it, and promotes fleet-wide or rolls back on two gates: the
gateway's rolling SLO window and the per-rung prediction-drift gauge
(:mod:`distegnn_tpu_torch.promote.drift`).
"""

from distegnn_tpu_torch.promote.drift import DriftGauge
from distegnn_tpu_torch.promote.promoter import Promoter
from distegnn_tpu_torch.promote.publish import (CandidatePublisher,
                                                config_hash,
                                                list_candidates,
                                                read_candidate)

__all__ = [
    "CandidatePublisher",
    "DriftGauge",
    "Promoter",
    "config_hash",
    "list_candidates",
    "read_candidate",
]
