"""Parameter conversion from the JAX package's flax tree to the port's
``state_dict`` (FastEGNN, ``edge_impl='fused'``).

The flax tree (``_EGCLVelStackParams`` in distegnn_tpu/models/fast_egnn.py
maps it on one screen):

  embedding_in/Dense_0/{kernel,bias}        -> embedding_in.{weight,bias}
  virtual_node_feat [1, H, C]               -> virtual_node_feat
  gcl_i/phi_e_fused/{w1,b1,w2,b2,w3,b3,w4}  -> gcl.i.phi_e_fused.* (as is)
  gcl_i/<mlp>/TorchDense_k/Dense_0/...      -> gcl.i.<mlp>.layers.k.*
  gcl_i/<coord>/MLP_0/TorchDense_k/...      -> gcl.i.<coord>.layers.k.*

Flax kernels are [in, out]; ``nn.Linear.weight`` is [out, in], so dense
kernels are transposed. The raw phi_e_fused arrays keep the JAX orientation.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_MLPS = ("phi_ev", "phi_v", "phi_h", "phi_hv")
_COORD_MLPS = ("phi_xv", "phi_X")
_FUSED = ("w1", "b1", "w2", "b2", "w3", "b3", "w4")


def _dense(tree: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    d = tree["Dense_0"] if "Dense_0" in tree else tree
    out[f"{prefix}.weight"] = torch.from_numpy(
        np.array(np.asarray(d["kernel"], np.float32).T, order="C"))
    if "bias" in d:
        out[f"{prefix}.bias"] = torch.from_numpy(
            np.asarray(d["bias"], np.float32).copy())


def _mlp(tree: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    k = 0
    while f"TorchDense_{k}" in tree:
        _dense(tree[f"TorchDense_{k}"], f"{prefix}.layers.{k}", out)
        k += 1
    if k == 0:
        raise KeyError(f"{prefix}: no TorchDense_k layers in the flax tree")


def params_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax FastEGNN(edge_impl='fused') params (numpy leaves, with or without
    the top-level ``params`` key) -> the port's FastEGNN ``state_dict``."""
    p = flax_params.get("params", flax_params)
    out: Dict[str, torch.Tensor] = {}
    out["virtual_node_feat"] = torch.from_numpy(
        np.asarray(p["virtual_node_feat"], np.float32).copy())
    _dense(p["embedding_in"], "embedding_in", out)
    i = 0
    while f"gcl_{i}" in p:
        gcl, pre = p[f"gcl_{i}"], f"gcl.{i}"
        if "phi_e_fused" not in gcl:
            raise KeyError(f"gcl_{i}: no phi_e_fused subtree — only the "
                           "edge_impl='fused' tree converts")
        for name in _FUSED:
            out[f"{pre}.phi_e_fused.{name}"] = torch.from_numpy(
                np.asarray(gcl["phi_e_fused"][name], np.float32).copy())
        for name in _MLPS:
            _mlp(gcl[name], f"{pre}.{name}", out)
        for name in _COORD_MLPS:
            _mlp(gcl[name]["MLP_0"], f"{pre}.{name}", out)
        i += 1
    return out
