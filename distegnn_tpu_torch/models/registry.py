"""Model factory (port of ``distegnn_tpu/models/registry.py``): FastEGNN
only so far."""

from __future__ import annotations

from typing import Optional

import torch

from distegnn_tpu_torch.models.fast_egnn import FastEGNN


def get_model(model_config, world_size: int = 1,
              dataset_name: Optional[str] = None,
              axis_name: Optional[str] = None,
              generator: Optional[torch.Generator] = None) -> FastEGNN:
    """``model_config``: attribute-style ``model:`` section of a config.

    ``axis_name`` is the graph axis of a distributed run ('graph', see
    parallel/mesh.py), None on one device; ``world_size`` and
    ``dataset_name`` are the JAX signature's and select nothing for
    FastEGNN. The model is built on the CPU, with its parameters drawn from
    ``generator``; move it with ``.to(device)``."""
    name = model_config.model_name
    if name != "FastEGNN":
        raise NotImplementedError(
            f"model {name!r}: only FastEGNN is ported to PyTorch so far")
    return FastEGNN(
        node_feat_nf=model_config.node_feat_nf,
        node_attr_nf=model_config.node_attr_nf,
        edge_attr_nf=model_config.edge_attr_nf,
        hidden_nf=model_config.hidden_nf,
        virtual_channels=model_config.virtual_channels,
        n_layers=model_config.n_layers,
        normalize=model_config.normalize,
        gravity=None,
        compute_dtype=model_config.get("compute_dtype"),
        remat=bool(model_config.get("remat", False)),
        blocked_impl=model_config.get("blocked_impl", "einsum"),
        hoist_edge_mlp=bool(model_config.get("hoist_edge_mlp", True)),
        segment_impl=model_config.get("segment_impl", "scatter"),
        fuse_agg=bool(model_config.get("fuse_agg", True)),
        agg_dtype=model_config.get("agg_dtype"),
        edge_impl=model_config.get("edge_impl", "plain"),
        stack_vmem_budget=int(model_config.get("stack_vmem_budget", 0) or 0),
        axis_name=axis_name, generator=generator)
