"""Loss functions (port of ``distegnn_tpu/train/loss.py``): the
node-weighted masked MSE and the MMD virtual-node regulariser.

Under a graph axis each part computes its MSE over its own nodes and
weights it by its share of the graph's nodes (the node counts summed over
the axis); the weighted shares sum to the global loss.

MMD: an RBF kernel exp(-d / (2 sigma^2)) on Euclidean distances between the
C virtual-node positions and ``samples * C`` target positions per graph,
loss = l_vv - l_rv. When the padded node axis is no longer than
``samples * C`` every real node is used once (no sampling); otherwise the
indices are a uniform draw over each graph's real-node prefix, taken from a
``torch.Generator`` the caller passes in, or injected (``idx``) so that a
test can feed the indices JAX drew.
"""

from __future__ import annotations

from typing import Optional

import torch

from distegnn_tpu_torch.parallel.collectives import _psum


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               node_mask: torch.Tensor) -> torch.Tensor:
    """MSE over the real nodes of the whole batch (mean over nodes * 3)."""
    err = (pred - target) ** 2 * node_mask[..., None]
    cnt = torch.clamp(torch.sum(node_mask), min=1.0)
    return torch.sum(err) / (cnt * pred.shape[-1])


def rbf_kernel_sum(x: torch.Tensor, y: torch.Tensor, sigma: float,
                   wx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_ij w_i * exp(-||x_i - y_j|| / (2 sigma^2)) over the last two axes
    (x [..., n, 3], y [..., m, 3], wx [..., n]); summed over everything."""
    d2 = torch.sum((x[..., :, None, :] - y[..., None, :, :]) ** 2, dim=-1)
    d = torch.sqrt(torch.clamp(d2, min=1e-24))
    k = torch.exp(-d / (2.0 * sigma * sigma))
    if wx is not None:
        k = k * wx[..., :, None]
    return torch.sum(k)


def mmd_loss(virtual_loc: torch.Tensor, target: torch.Tensor,
             node_mask: torch.Tensor, sigma: float, samples: int,
             generator: Optional[torch.Generator] = None,
             idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """virtual_loc [B, 3, C], target [B, N, 3], node_mask [B, N].

    The l_rv denominator is always ``samples * C``, as in the reference.
    Sampling branch (N > samples * C): ``idx`` [B, samples * C] node indices,
    or drawn as min(floor(u * n), N - 1) with u uniform from ``generator``;
    a graph with n < samples * C real nodes is weighted n / (samples * C)."""
    B, N, _ = target.shape
    C = virtual_loc.shape[2]
    num_sample = samples * C
    V = virtual_loc.transpose(1, 2)                           # [B, C, 3]
    k_vv = rbf_kernel_sum(V, V, sigma)
    if N <= num_sample:
        k_rv = rbf_kernel_sum(target, V, sigma, wx=node_mask)
    else:
        n = torch.sum(node_mask, dim=1)                       # [B]
        if idx is None:
            u = torch.rand((B, num_sample), generator=generator,
                           device=target.device)
            idx = torch.clamp((u * n[:, None]).to(torch.int64), max=N - 1)
        picked = torch.gather(target, 1,
                              idx.long()[..., None].expand(-1, -1, 3))
        w = torch.clamp(n, max=float(num_sample)) / num_sample   # [B]
        d2 = torch.sum((picked[:, :, None, :] - V[:, None, :, :]) ** 2,
                       dim=-1)
        k = torch.exp(-torch.sqrt(torch.clamp(d2, min=1e-24))
                      / (2.0 * sigma * sigma))
        k_rv = torch.sum(torch.sum(k, dim=(1, 2)) * w)
    l_vv = k_vv / B / C / C
    l_rv = 2.0 * k_rv / B / num_sample / C
    return l_vv - l_rv


def weighted_local_loss(local_loss: torch.Tensor, node_mask: torch.Tensor,
                        axis_name: Optional[str] = None) -> torch.Tensor:
    """This part's node-weighted share of the global loss,
    local_loss * node_cnt / total_node_cnt (the count summed over the
    axis, a name or a tuple of names). Not summed across parts: each rank
    differentiates its own share
    and the step sums the parameter gradients. On one device it is
    ``local_loss`` itself."""
    node_cnt = torch.sum(node_mask)
    total = _psum(node_cnt, axis_name)
    return local_loss * node_cnt / torch.clamp(total, min=1.0)


def weighted_global_loss(local_loss: torch.Tensor, node_mask: torch.Tensor,
                         axis_name: Optional[str] = None) -> torch.Tensor:
    """The node-weighted global loss, the shares summed across parts (the
    logged and evaluated quantity)."""
    return _psum(weighted_local_loss(local_loss, node_mask, axis_name),
                 axis_name)
