"""The process-group layout of a distributed run (port of
``distegnn_tpu/parallel/mesh.py``).

One process per rank; rank r holds graph part r and trains on
``cuda:(r % torch.cuda.device_count())`` (or the CPU where the caller asks
for it). The ``graph`` axis is the whole world: the per-layer virtual-node
sums, the loss's node counts and the gradient sum run over it. The
``data`` and ``tensor`` axes of the JAX mesh are not ported (config.py
refuses them).

Backend: ``nccl`` when every rank has a card of its own; ``gloo`` when
ranks share a card (NCCL refuses two ranks on one GPU) and on the CPU. Gloo
reduces CUDA tensors through the host; the model computes on the card
either way.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

GRAPH_AXIS = "graph"
DATA_AXIS = "data"
TENSOR_AXIS = "tensor"

# axis name -> process group, set by init_graph_group in this process
_GROUPS: dict = {}


class GraphGroup(NamedTuple):
    """The graph axis of this process: its group, backend, rank, size and
    the device the rank computes on."""

    group: "dist.ProcessGroup"
    backend: str
    rank: int
    world_size: int
    device: torch.device


def backend_for(world_size: int, device_type: str) -> str:
    """``nccl`` when each of ``world_size`` ranks has a card of its own,
    else ``gloo``."""
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_graph_group(world_size: int, rank: int, device: str = "cuda",
                     init_method: str = "env://") -> GraphGroup:
    """Join the process group as ``rank`` of ``world_size`` and bind it to
    :data:`GRAPH_AXIS`. ``device`` 'cuda' takes card ``rank % count`` (and
    raises without one), 'cpu' the CPU. Rank 0 prints the backend rule."""
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distegnn_tpu_torch: CUDA is not available; "
                               "pass device='cpu' to run the ranks on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    backend = backend_for(world_size, dev_type)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    if rank == 0:
        cards = torch.cuda.device_count() if dev_type == "cuda" else 0
        print(f"[dist] {world_size} rank(s) on {dev_type} ({cards} card(s)): "
              f"backend {backend} — nccl when every rank has a card of its "
              "own, gloo when ranks share a card or run on the CPU (gloo "
              "reduces CUDA tensors through the host)", flush=True)
    group = dist.group.WORLD
    _GROUPS[GRAPH_AXIS] = group
    return GraphGroup(group, backend, rank, world_size, dev)


def axis_group(axis_name: str) -> "dist.ProcessGroup":
    """The process group bound to ``axis_name``."""
    group = _GROUPS.get(axis_name)
    if group is None:
        raise RuntimeError(
            f"axis {axis_name!r} has no process group in this process: call "
            "parallel.mesh.init_graph_group first (parallel/launch.py does)")
    return group


def destroy_graph_group() -> None:
    """Leave the process group (a no-op outside one)."""
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
