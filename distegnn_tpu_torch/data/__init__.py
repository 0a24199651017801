"""The data layer (port of ``distegnn_tpu/data``): the n-body generator,
the per-dataset preprocessing pipelines (n-body, Water-3D, protein,
Fluid113K; cutoff and distribute modes), the static-shape loaders and the
out-of-core shard directories."""

from distegnn_tpu_torch.data.loader import (GraphDataset, GraphLoader,
                                            PrefetchLoader, shard_loader)
from distegnn_tpu_torch.data.nbody import (build_nbody_graph,
                                           process_nbody_cutoff)
from distegnn_tpu_torch.data.nbody_sim import (ChargedSystem,
                                               generate_nbody_files,
                                               simulate_trajectories_batched,
                                               simulate_trajectory)
from distegnn_tpu_torch.data.protein import (build_protein_graph,
                                             extract_adk_npz,
                                             process_protein_cutoff)
from distegnn_tpu_torch.data.stream import (ShardChecksumError,
                                            StreamedGraphDataset,
                                            is_shard_dir, open_dataset,
                                            write_shards)
from distegnn_tpu_torch.data.water3d import (build_water3d_graph,
                                             process_water3d_cutoff,
                                             process_water3d_distribute)

__all__ = [
    "ChargedSystem",
    "GraphDataset",
    "GraphLoader",
    "PrefetchLoader",
    "ShardChecksumError",
    "StreamedGraphDataset",
    "build_nbody_graph",
    "build_protein_graph",
    "build_water3d_graph",
    "extract_adk_npz",
    "generate_nbody_files",
    "is_shard_dir",
    "open_dataset",
    "process_nbody_cutoff",
    "process_protein_cutoff",
    "process_water3d_cutoff",
    "process_water3d_distribute",
    "shard_loader",
    "simulate_trajectories_batched",
    "simulate_trajectory",
    "write_shards",
]
