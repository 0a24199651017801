"""Distributed consistency checks (port of
``distegnn_tpu/parallel/checks.py``).

Replication is by construction (every rank applies the same summed update),
so a divergence between ranks means a real fault: a non-deterministic
collective, loader drift, a corrupted shard. These checks make the
invariant executable:

- :func:`assert_replicated`: every rank's parameters equal rank 0's bit
  for bit (one broadcast, one MIN of the verdict over the axis's group).
  ``parallel/launch.py`` runs it over the whole mesh at the start and the
  end of a run, and the trainer at every eval epoch under
  ``log.check_consistency``.
- :func:`batch_fingerprint`: a digest of a batch's tensors; ranks feeding
  the same logical batch in lockstep produce the same fingerprint.
"""

from __future__ import annotations

import hashlib

import torch
import torch.distributed as dist

from distegnn_tpu_torch.parallel.collectives import all_reduce
from distegnn_tpu_torch.parallel.mesh import axis_group


def assert_replicated(model: torch.nn.Module, axis_name,
                      when: str) -> None:
    """Raise on every rank unless every rank's parameters equal rank 0's
    bit for bit (one broadcast of the flattened parameters, one MIN of the
    verdict)."""
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, 0, group=axis_group(axis_name))
    same = torch.tensor([int(torch.equal(flat, ref))], device=flat.device)
    all_reduce(same, axis_name, "replicated", op=dist.ReduceOp.MIN)
    if int(same.item()) != 1:
        raise AssertionError(f"parameters differ across ranks at the {when} "
                             "of the run")


def tree_fingerprint(tree) -> bytes:
    """A 16-byte digest of the bytes of every tensor or array in ``tree``
    (a tensor, an array, a dict / list / tuple of them, or an object whose
    attributes hold them, in attribute order)."""
    h = hashlib.blake2b(digest_size=16)

    def visit(x):
        if isinstance(x, torch.Tensor):
            h.update(x.detach().cpu().contiguous().reshape(-1)
                     .view(torch.uint8).numpy().tobytes())
        elif hasattr(x, "tobytes"):
            h.update(x.tobytes())
        elif isinstance(x, dict):
            for k in sorted(x):
                visit(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif hasattr(x, "__dict__"):
            for v in vars(x).values():
                visit(v)

    visit(tree)
    return h.digest()


def batch_fingerprint(batch) -> bytes:
    """The digest of a batch: ranks feeding the same logical batch in
    lockstep give the same fingerprint (the reference's per-step graph
    signature)."""
    return tree_fingerprint(batch)
