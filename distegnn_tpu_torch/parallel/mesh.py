"""The process-group layout of a distributed run (port of
``distegnn_tpu/parallel/mesh.py``).

One process per rank. The world is the JAX mesh (data, graph, tensor) of
shape (D, P, T), laid out as JAX lays its devices: rank
``r = (d * P + g) * T + t``, the tensor axis innermost. Rank r trains on
``cuda:(r % torch.cuda.device_count())`` (or the CPU where the caller asks
for it) and holds graph part g of data shard d; its tensor coordinate t
selects its 1/T slice of the hidden width.

Axes and the groups their collectives run over (every rank creates every
group, in the same order):

  graph        the ranks with the same (d, t): the per-layer virtual-node
               sums;
  tensor       the ranks with the same (d, g): the hidden-width collectives
               of ``tp_*`` (parallel/collectives.py);
  data, graph  the ranks with the same t: the loss's node weighting and the
               gradient sum (train/step.py);
  the world    all three axes: the preemption guard's stop agreement and
               the replication check.

``axis_group`` resolves an axis name or a tuple of names. At D = T = 1 every
one of them but ``tensor`` is the whole world, and no sub-group is made:
the graph-only run of earlier slices, unchanged.

Backend: ``nccl`` when every rank has a card of its own; ``gloo`` when
ranks share a card (NCCL refuses two ranks on one GPU) and on the CPU. Gloo
reduces CUDA tensors through the host; the model computes on the card
either way. The sub-groups take the world's backend.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

GRAPH_AXIS = "graph"
DATA_AXIS = "data"
TENSOR_AXIS = "tensor"
AXES = (DATA_AXIS, GRAPH_AXIS, TENSOR_AXIS)
# the whole world's axes
WORLD_AXES = AXES

# frozenset of axis names -> process group; the mesh shape and this rank's
# coordinates; all set by init_graph_group in this process
_GROUPS: dict = {}
_MESH: dict = {}


class GraphGroup(NamedTuple):
    """This process in the mesh: the graph axis's group, the backend, the
    rank and size of the world, and the device the rank computes on."""

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


def mesh_coords(rank: int, shape: Sequence[int]) -> Tuple[int, int, int]:
    """(d, g, t) of ``rank`` in a (D, P, T) mesh: rank = (d P + g) T + t."""
    _, P, T = shape
    return rank // (P * T), (rank // T) % P, rank % T


def _members(shape, axes) -> list:
    """The rank lists of the groups spanning ``axes``: one per value of the
    other coordinates, in rank order."""
    D, P, T = shape
    groups: dict = {}
    for r in range(D * P * T):
        c = mesh_coords(r, shape)
        key = tuple(v for a, v in zip(AXES, c) if a not in axes)
        groups.setdefault(key, []).append(r)
    return [groups[k] for k in sorted(groups)]


def init_graph_group(world_size: int, rank: int, device: str = "cuda",
                     init_method: str = "env://",
                     mesh: Optional[Sequence[int]] = None) -> GraphGroup:
    """Join the process group as ``rank`` of ``world_size`` and lay the
    world out as the (data, graph, tensor) mesh ``mesh`` = (D, P, T)
    (default (1, world_size, 1): the graph axis alone). ``device`` 'cuda'
    takes card ``rank % count`` (and raises without one), 'cpu' the CPU.
    Rank 0 prints the backend rule."""
    shape = tuple(int(v) for v in (mesh or (1, world_size, 1)))
    if len(shape) != 3 or min(shape) < 1 or \
            shape[0] * shape[1] * shape[2] != world_size:
        raise ValueError(f"mesh {shape} (data x graph x tensor) does not "
                         f"lay out a world of {world_size} ranks")
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
        print(f"[dist] {world_size} rank(s) on {dev_type} ({cards} card(s)), "
              f"mesh data x graph x tensor = {shape[0]} x {shape[1]} x "
              f"{shape[2]}: backend {backend} — nccl when every rank has a "
              "card of its own, gloo when ranks share a card or run on the "
              "CPU (gloo reduces CUDA tensors through the host)", flush=True)
    world = dist.group.WORLD
    _MESH.update(shape=shape, coords=mesh_coords(rank, shape))
    _GROUPS[frozenset(WORLD_AXES)] = world
    sizes = dict(zip(AXES, shape))
    # every rank makes every group, in this order
    for axes in ((GRAPH_AXIS,), (TENSOR_AXIS,), (DATA_AXIS, GRAPH_AXIS)):
        n = 1
        for a in axes:
            n *= sizes[a]
        if n == world_size:
            _GROUPS[frozenset(axes)] = world
        elif shape != (1, world_size, 1):
            group, _ = dist.new_subgroups_by_enumeration(
                _members(shape, axes))
            _GROUPS[frozenset(axes)] = group
    return GraphGroup(_GROUPS[frozenset((GRAPH_AXIS,))], backend, rank,
                      world_size, dev)


def _key(axis_name: Union[str, Sequence[str]]) -> frozenset:
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    unknown = [a for a in names if a not in AXES]
    if unknown or not names:
        raise ValueError(f"unknown mesh axis {axis_name!r} (valid: {AXES})")
    return frozenset(names)


def axis_group(axis_name: Union[str, Sequence[str]]) -> "dist.ProcessGroup":
    """The process group of ``axis_name``: one axis name or a tuple of
    them (``('data', 'graph')``, the whole ``AXES``)."""
    group = _GROUPS.get(_key(axis_name))
    if group is None:
        raise RuntimeError(
            f"axis {axis_name!r} has no process group in this process: call "
            "parallel.mesh.init_graph_group first (parallel/launch.py does)")
    return group


def axis_size(axis_name: Union[str, Sequence[str]]) -> int:
    """How many ranks the group of ``axis_name`` holds."""
    return dist.get_world_size(axis_group(axis_name))


def axis_index(axis_name: str) -> int:
    """This rank's coordinate on ``axis_name`` (JAX's
    ``lax.axis_index``)."""
    if axis_name not in AXES:
        raise ValueError(f"unknown mesh axis {axis_name!r} (valid: {AXES})")
    mesh_shape()   # raises outside a mesh
    return _MESH["coords"][AXES.index(axis_name)]


def mesh_shape() -> Tuple[int, int, int]:
    """(D, P, T) of this process's mesh."""
    if not _MESH:
        raise RuntimeError("no mesh in this process: call "
                           "parallel.mesh.init_graph_group first")
    return _MESH["shape"]


def destroy_graph_group() -> None:
    """Leave the process group (a no-op outside one)."""
    _GROUPS.clear()
    _MESH.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
