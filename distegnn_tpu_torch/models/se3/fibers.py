"""Fiber algebra (port of ``distegnn_tpu/models/se3/fibers.py``):
degree/multiplicity bookkeeping for SE(3) features.

A feature dict maps degree d -> array [B, N, m_d, 2d+1]."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class Fiber:
    """structure: list of (multiplicity, degree), sorted by degree."""

    def __init__(self, num_degrees: Optional[int] = None,
                 num_channels: Optional[int] = None,
                 structure: Optional[List[Tuple[int, int]]] = None,
                 dictionary: Optional[Dict[int, int]] = None):
        if structure is not None:
            self.structure = sorted(structure, key=lambda t: t[1])
        elif dictionary is not None:
            self.structure = [(dictionary[d], d) for d in sorted(dictionary)]
        else:
            self.structure = [(num_channels, d) for d in range(num_degrees)]
        self.multiplicities, self.degrees = zip(*self.structure)
        self.max_degree = max(self.degrees)
        self.structure_dict = {d: m for m, d in self.structure}
        self.n_features = sum(m * (2 * d + 1) for m, d in self.structure)

    @staticmethod
    def combine_max(f1: "Fiber", f2: "Fiber") -> "Fiber":
        d = dict(f1.structure_dict)
        for k, m in f2.structure_dict.items():
            d[k] = max(m, d.get(k, 0))
        return Fiber(dictionary=d)

    def __repr__(self):
        return f"Fiber({self.structure})"
