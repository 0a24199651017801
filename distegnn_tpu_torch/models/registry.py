"""Model factory (port of ``distegnn_tpu/models/registry.py``): the same
ten families by ``model_name``, with the SchNet interatomic cutoffs by
dataset (nbody 1, protein 10, Water-3D 0.035)."""

from __future__ import annotations

from typing import Optional

import torch

_SCHNET_CUTOFFS = {"nbody_100": 1.0, "protein": 10.0, "Water-3D": 0.035}


def get_model(model_config, world_size: int = 1,
              dataset_name: Optional[str] = None,
              axis_name: Optional[str] = None,
              generator: Optional[torch.Generator] = None,
              tensor_axis: Optional[str] = None) -> torch.nn.Module:
    """``model_config``: attribute-style ``model:`` section of a config.

    ``axis_name`` is the graph axis of a distributed run ('graph', see
    parallel/mesh.py), None on one device: the virtual-node families take
    it (FastEGNN, FastRF, FastSchNet, as in JAX). ``tensor_axis`` is the
    tensor axis ('tensor' when ``parallel.mesh.tensor`` > 1, else None):
    FastEGNN alone takes it, as in JAX. ``dataset_name`` selects
    the SchNet cutoff (FastSchNet, SchNet); ``world_size`` is the JAX
    signature's and selects nothing. The model is built on the CPU, with
    its parameters drawn from ``generator``; move it with ``.to(device)``.
    """
    m = model_config
    name = m.model_name
    if tensor_axis is not None and name != "FastEGNN":
        raise ValueError(
            f"tensor parallelism (parallel.mesh.tensor > 1) is only "
            f"implemented for FastEGNN, not {name!r}")
    gen = dict(generator=generator)
    if name == "FastEGNN":
        from distegnn_tpu_torch.models.fast_egnn import FastEGNN

        return FastEGNN(
            node_feat_nf=m.node_feat_nf, node_attr_nf=m.node_attr_nf,
            edge_attr_nf=m.edge_attr_nf, hidden_nf=m.hidden_nf,
            virtual_channels=m.virtual_channels, n_layers=m.n_layers,
            normalize=m.normalize, gravity=None,
            compute_dtype=m.get("compute_dtype"),
            remat=bool(m.get("remat", False)),
            blocked_impl=m.get("blocked_impl", "einsum"),
            hoist_edge_mlp=bool(m.get("hoist_edge_mlp", True)),
            segment_impl=m.get("segment_impl", "scatter"),
            fuse_agg=bool(m.get("fuse_agg", True)),
            agg_dtype=m.get("agg_dtype"),
            edge_impl=m.get("edge_impl", "plain"),
            stack_vmem_budget=int(m.get("stack_vmem_budget", 0) or 0),
            axis_name=axis_name, tensor_axis=tensor_axis, **gen)
    if name == "FastRF":
        from distegnn_tpu_torch.models.fast_rf import FastRF

        return FastRF(
            edge_attr_nf=m.edge_attr_nf, hidden_nf=m.hidden_nf,
            n_layers=m.n_layers, virtual_channels=m.virtual_channels,
            axis_name=axis_name,
            blocked_impl=m.get("blocked_impl", "einsum"),
            segment_impl=m.get("segment_impl", "scatter"), **gen)
    if name in ("FastSchNet", "SchNet"):
        cutoff = _SCHNET_CUTOFFS.get(dataset_name)
        if cutoff is None:
            raise ValueError(
                f"no SchNet cutoff known for dataset {dataset_name!r}")
        if name == "FastSchNet":
            from distegnn_tpu_torch.models.fast_schnet import FastSchNet

            return FastSchNet(
                node_feat_nf=m.node_feat_nf, node_attr_nf=m.node_attr_nf,
                edge_attr_nf=m.edge_attr_nf, hidden_nf=m.hidden_nf,
                virtual_channels=m.virtual_channels, n_layers=m.n_layers,
                normalize=m.normalize, cutoff=cutoff, axis_name=axis_name,
                blocked_impl=m.get("blocked_impl", "einsum"),
                hoist_edge_mlp=bool(m.get("hoist_edge_mlp", True)),
                segment_impl=m.get("segment_impl", "scatter"),
                fuse_agg=bool(m.get("fuse_agg", True)),
                agg_dtype=m.get("agg_dtype"), **gen)
        from distegnn_tpu_torch.models.schnet import SchNet

        return SchNet(m.node_feat_nf, hidden_channels=m.hidden_nf,
                      cutoff=cutoff, **gen)
    if name == "EGNN":
        from distegnn_tpu_torch.models.basic import EGNN

        return EGNN(n_layers=m.n_layers, in_node_nf=m.node_feat_nf,
                    in_edge_nf=m.edge_attr_nf, hidden_nf=m.hidden_nf,
                    with_v=True, **gen)
    if name == "RF":
        from distegnn_tpu_torch.models.basic import RFVel

        return RFVel(hidden_nf=m.hidden_nf, edge_attr_nf=m.edge_attr_nf,
                     n_layers=m.n_layers, **gen)
    if name == "TFN":
        from distegnn_tpu_torch.models.se3.dynamics import TFNDynamics

        return TFNDynamics(nf=m.hidden_nf // 2, n_layers=m.n_layers,
                           num_degrees=2, **gen)
    if name == "SE3Transformer":
        from distegnn_tpu_torch.models.se3.dynamics import \
            SE3TransformerDynamics

        return SE3TransformerDynamics(nf=m.hidden_nf // 2,
                                      n_layers=m.n_layers, num_degrees=2,
                                      **gen)
    if name == "FastTFN":
        from distegnn_tpu_torch.models.fast_tfn import FastTFN

        return FastTFN(
            node_feat_nf=m.node_feat_nf, node_attr_nf=m.node_attr_nf,
            edge_attr_nf=m.edge_attr_nf, hidden_nf=m.hidden_nf,
            virtual_channels=m.virtual_channels, n_layers=m.n_layers,
            normalize=m.normalize, **gen)
    if name == "Linear":
        from distegnn_tpu_torch.models.basic import LinearDynamics

        return LinearDynamics(**gen)
    raise NotImplementedError(f"Model {name} not implemented")
