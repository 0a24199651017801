"""Parameter conversion from the JAX package's flax tree to the port's
``state_dict`` (FastEGNN, ``edge_impl`` 'fused', 'fused_stack' or 'plain';
a 'fused_stack' tree is the 'fused' tree).

The flax tree:

  embedding_in/Dense_0/{kernel,bias}        -> embedding_in.{weight,bias}
  virtual_node_feat [1, H, C]               -> virtual_node_feat
  gcl_i/<mlp>/TorchDense_k/Dense_0/...      -> gcl.i.<mlp>.layers.k.*
  gcl_i/<coord>/MLP_0/TorchDense_k/...      -> gcl.i.<coord>.layers.k.*
  fused:
  gcl_i/phi_e_fused/{w1,b1,w2,b2,w3,b3,w4}  -> gcl.i.phi_e_fused.* (as is)
  plain:
  gcl_i/phi_e/{kernel,bias}                 -> gcl.i.phi_e.{kernel,bias} (as
                                               is; hoist_edge_mlp=True)
  gcl_i/phi_e/TorchDense_0/Dense_0/...      -> gcl.i.phi_e.dense.* (hoisted)
                                               or gcl.i.phi_e.layers.0.*
  gcl_i/phi_e/TorchDense_1/Dense_0/...      -> gcl.i.phi_e.layers.1.* (the
                                               concat MLP)
  gcl_i/phi_x/MLP_0/TorchDense_k/...        -> gcl.i.phi_x.layers.k.*
  gcl_i/{att,att_v}/Dense_0/{kernel,bias}   -> gcl.i.{att,att_v}.* (attention)
  gcl_i/phi_g/TorchDense_k/Dense_0/...      -> gcl.i.phi_g.layers.k.* (gravity)

Flax kernels are [in, out]; ``nn.Linear.weight`` is [out, in], so dense
kernels are transposed. The raw phi_e_fused arrays and the hoisted phi_e
kernel keep the JAX orientation.
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


def _raw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def params_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax FastEGNN params (numpy leaves, with or without the top-level
    ``params`` key) -> the port's FastEGNN ``state_dict``."""
    p = flax_params.get("params", flax_params)
    out: Dict[str, torch.Tensor] = {}
    out["virtual_node_feat"] = _raw(p["virtual_node_feat"])
    _dense(p["embedding_in"], "embedding_in", out)
    i = 0
    while f"gcl_{i}" in p:
        gcl, pre = p[f"gcl_{i}"], f"gcl.{i}"
        if "phi_e_fused" in gcl:
            for name in _FUSED:
                out[f"{pre}.phi_e_fused.{name}"] = _raw(
                    gcl["phi_e_fused"][name])
        else:
            pe = gcl["phi_e"]
            if "kernel" in pe:                      # HoistedEdgeMLP
                out[f"{pre}.phi_e.kernel"] = _raw(pe["kernel"])
                out[f"{pre}.phi_e.bias"] = _raw(pe["bias"])
                _dense(pe["TorchDense_0"], f"{pre}.phi_e.dense", out)
            else:
                _mlp(pe, f"{pre}.phi_e", out)
            _mlp(gcl["phi_x"]["MLP_0"], f"{pre}.phi_x", out)
        for name in ("att", "att_v"):
            if name in gcl:
                _dense(gcl[name], f"{pre}.{name}", out)
        for name in _MLPS:
            _mlp(gcl[name], f"{pre}.{name}", out)
        if "phi_g" in gcl:
            _mlp(gcl["phi_g"], f"{pre}.phi_g", out)
        for name in _COORD_MLPS:
            _mlp(gcl[name]["MLP_0"], f"{pre}.{name}", out)
        i += 1
    return out
