"""Cross-layer fused megakernel — all L EGCL layers of one graph in one
launch (port of ``distegnn_tpu/ops/layer_pipeline.py``).

``fused_egnn_stack`` runs the whole FastEGNN layer stack of one blocked
``split_remote`` graph: per layer the hoisted phi_e products, the in-window
edge pass (the math of ``fused_edge_layer``), the remote tail, the virtual
section and the node / virtual updates. It returns the final state and the
four ``[L, ...]`` layer-INPUT checkpoints, which are the backward's anchors.

``fused_egnn_stack_batch`` runs it for a batch of graphs (a leading batch
axis on every per-graph operand). On CUDA tensors it launches the
hand-written kernel ``csrc/fused_stack_fwd.cu`` once for the whole batch (one
cooperative launch, a grid-wide sync between the phases of each layer); on
CPU tensors it runs the plain version ``fused_egnn_stack_batch_ref``, the
layer loop over the same math, graph by graph. ``fused_egnn_stack`` is the
same on one graph (a batch of one), with the JAX package's signature. There
is no backward kernel, as in the JAX package: ``FusedEgnnStack.backward``
walks each graph's layers in reverse, reruns each one through ``_layer_ref``
from its checkpoint (whose in-window pass IS ``fused_edge_layer``, so per
layer and graph one forward and one backward launch of the fused edge
kernels on the card) and takes its vector-Jacobian product.

Scale contract, kept from the JAX package with the same numbers: the whole
graph must fit. ``estimate_stack_vmem_bytes`` models the residency and
``check_stack_vmem`` raises the typed ``StackVmemBudgetError`` above the
budget (16 MiB by default) before any launch. On the H100 the budget bounds
the working set the kernel keeps L2-resident (50 MB), and it keeps the set
of shapes each config admits equal to the JAX package's.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from distegnn_tpu_torch.ops.edge_pipeline import (OH_CHUNK, XL, EdgeWeights,
                                                  _check, _check_grid,
                                                  _on_device, _silu,
                                                  fused_edge_layer,
                                                  fused_edge_layer_ref)

DEFAULT_STACK_VMEM_BUDGET = 16 * 1024 * 1024


class StackVmemBudgetError(ValueError):
    """The megakernel's residency estimate exceeds the declared budget.

    Raised before any launch (typed, catchable). Fix: use
    ``edge_impl: fused`` for this shape, shrink the rung, or raise the budget
    knowingly via StackConfig.vmem_budget."""


class StackConfig(NamedTuple):
    """Static megakernel configuration."""

    n_layers: int
    block: int               # node block == edge tile T (edge_pipeline)
    hidden: int              # H
    channels: int            # C virtual channels
    node_attr_nf: int = 0    # A (0 = the batch carries no node_attr)
    has_gravity: bool = False
    residual: bool = True
    coords_mean: bool = True  # coords_agg == 'mean'
    dtype_name: str = "f32"   # 'f32' | 'bf16' (message-MLP compute dtype)
    vmem_budget: int = DEFAULT_STACK_VMEM_BUDGET


SCALAR_NF = 3  # radial + 2 edge attrs — the fused kernel's scalar lanes


def stack_weight_shapes(cfg: StackConfig) -> Dict[str, Tuple[int, int]]:
    """Per-layer 2-D shapes of every stacked weight, keyed by kernel name
    (the stacked container is ``{key: [L, a, b]}``, a run-time view of the
    per-layer ``edge_impl='fused'`` parameters)."""
    H, C, A = cfg.hidden, cfg.channels, cfg.node_attr_nf
    shapes = {
        # phi_e + phi_x head (EdgeWeights layout: row biases, e_w4 [1, H])
        "e_w1": (2 * H + SCALAR_NF, H), "e_b1": (1, H),
        "e_w2": (H, H), "e_b2": (1, H),
        "e_w3": (H, H), "e_b3": (1, H), "e_w4": (1, H),
        # phi_ev: MLP([H, H], act_last=True) on [h, Hv, |vcd|, m_X]
        "ev_k0": (2 * H + 1 + C, H), "ev_b0": (1, H),
        "ev_k1": (H, H), "ev_b1": (1, H),
        # phi_xv / phi_X: CoordMLP (no last bias)
        "xv_k0": (H, H), "xv_b0": (1, H), "xv_k1": (H, 1),
        "X_k0": (H, H), "X_b0": (1, H), "X_k1": (H, 1),
        # phi_v: MLP([H, 1])
        "v_k0": (H, H), "v_b0": (1, H), "v_k1": (H, 1), "v_b1": (1, 1),
        # phi_h: MLP([H, H]) on [h, agg_h, agg_v(, node_attr)]
        "h_k0": (3 * H + A, H), "h_b0": (1, H),
        "h_k1": (H, H), "h_b1": (1, H),
        # phi_hv: MLP([H, H]) on [Hv^T, agg_Hv]
        "hv_k0": (2 * H, H), "hv_b0": (1, H),
        "hv_k1": (H, H), "hv_b1": (1, H),
    }
    if cfg.has_gravity:
        shapes.update({"g_k0": (H, H), "g_b0": (1, H),
                       "g_k1": (H, 1), "g_b1": (1, 1)})
    return shapes


# ------------------------------------------------------------ memory models

def estimate_stack_vmem_bytes(cfg: StackConfig, *, n_nodes: int,
                              n_edges: int, remote_pad: int) -> int:
    """The JAX package's model of the megakernel's peak residency in bytes
    (the same items and numbers): bounded in L, with every coexisting
    temporary counted."""
    H, C, A = cfg.hidden, cfg.channels, cfg.node_attr_nf
    N, E, R = n_nodes, n_edges, remote_pad
    db = 2 if cfg.dtype_name == "bf16" else 4
    T = cfg.block
    w_bytes = 4 * sum(a * b for a, b in stack_weight_shapes(cfg).values())
    items = {
        "edge_stream": E * (4 + 4 + 4 + XL * 4),
        "node_inputs": N * (2 * XL * 4 + H * 4 + 4 + A * 4),
        "state_scratch": 2 * N * (XL + H) * 4,
        "outputs": 2 * N * (XL + H) * 4,
        "layer_weights": 2 * w_bytes,
        "hoisted": N * 4 * H * db,
        "accumulator": N * (H + 8) * 4 + T * (H + 8) * 4,
        "remote": R * (XL * 4 + 8 + 3 * H * db) + 2 * R * N * 4,
        "virtual": N * C * ((2 * H + 1 + C) + 2 * H) * db + 2 * N * 3 * C * 4,
    }
    return int(sum(items.values()))


def check_stack_vmem(cfg: StackConfig, *, n_nodes: int, n_edges: int,
                     remote_pad: int) -> int:
    """Raise StackVmemBudgetError if the estimate exceeds cfg.vmem_budget;
    returns the estimate."""
    est = estimate_stack_vmem_bytes(cfg, n_nodes=n_nodes, n_edges=n_edges,
                                    remote_pad=remote_pad)
    if est > cfg.vmem_budget:
        raise StackVmemBudgetError(
            f"fused_stack megakernel needs ~{est / 2**20:.1f} MiB VMEM-resident "
            f"state (N={n_nodes}, E={n_edges}, R={remote_pad}, H={cfg.hidden}, "
            f"block={cfg.block}) but the budget is "
            f"{cfg.vmem_budget / 2**20:.1f} MiB — the graph must fit on-chip "
            f"for the cross-layer fusion to pay. Use edge_impl='fused' for "
            f"this shape, shrink the serving rung, or raise "
            f"StackConfig.vmem_budget explicitly")
    return est


def hbm_bytes_per_step(impl: str, *, n_nodes: int, n_edges: int, hidden: int,
                       channels: int, n_layers: int, remote_pad: int = 0,
                       node_attr_nf: int = 0,
                       dtype_name: str = "f32") -> Dict[str, int]:
    """The JAX package's analytic bytes-per-forward-step model of the three
    edge lowerings (derived from shapes only; every operand read or written
    once per use site, weights re-read per layer). Returns
    ``{"total": bytes, ...itemized}``."""
    N, E, H, C, L, R, A = (n_nodes, n_edges, hidden, channels, n_layers,
                           remote_pad, node_attr_nf)
    db = 2 if dtype_name == "bf16" else 4
    edge_stream = E * (4 + 4 + 4 + XL * 4)
    remote_stream = R * (8 + XL * 4)
    state = N * (XL * 4 + XL * 4 + H * 4 + 4 + A * 4)
    cfg = StackConfig(n_layers=L, block=OH_CHUNK, hidden=H, channels=C,
                      node_attr_nf=A, has_gravity=False,
                      dtype_name=dtype_name)
    w_layer = 4 * sum(a * b for a, b in stack_weight_shapes(cfg).values())
    virt = N * C * H * db
    if impl == "fused_stack":
        items = {
            "edge_stream_once": edge_stream,
            "remote_once": remote_stream,
            "state_io": 2 * state,
            "weights_L": L * w_layer,
            "ckpt_writes": L * N * (XL + H) * 4,
        }
    elif impl == "fused":
        per_layer = (edge_stream + remote_stream
                     + 4 * N * (XL * 4 + 2 * H * db)
                     + N * (H + 8) * 4
                     + 2 * state + w_layer + 2 * virt)
        items = {"per_layer_x_L": L * per_layer}
    elif impl == "plain":
        per_layer = (E * H * db * 5 + E * 3 * 4 * 2 + 2 * state
                     + w_layer + 2 * virt)
        items = {"per_layer_x_L": L * per_layer}
    else:
        raise ValueError(f"unknown impl {impl!r}")
    items["total"] = int(sum(items.values()))
    return items


# ------------------------------------------------------- shared layer math

def _dt(cfg: StackConfig):
    return None if cfg.dtype_name == "f32" else torch.bfloat16


def _cast(dt):
    return (lambda a: a.to(dt)) if dt is not None else (lambda a: a)


def _dense(x, k, b, dt):
    """Dense(dtype=dt) on tensors: inputs AND parameters cast to dt."""
    c = _cast(dt)
    y = c(x) @ c(k)
    return y + c(b) if b is not None else y


def _mlp2(x, k0, b0, k1, b1, dt, act_last=False):
    y = _silu(_dense(x, k0, b0, dt))
    y = _dense(y, k1, b1, dt)
    return _silu(y) if act_last else y


def _coord_head(x, k0, b0, k1, dt):
    """CoordMLP: Dense(H) -> silu -> Dense(1, no bias) -> f32."""
    y = _silu(_dense(x, k0, b0, dt))
    return _dense(y, k1, None, dt).to(torch.float32)


def _remote_edge_math(x_r, x_c, hr_r, hc_c, rattr, rm, w, H, dt):
    """Per-edge remote-tail math on gathered values (EGCLVel's dense tail):
    returns (cd_r [R, 3], g_r [R, 1], ef_r [R, H])."""
    c = _cast(dt)
    cd_r = (x_r - x_c) * rm
    radial = torch.sum(cd_r * cd_r, dim=-1, keepdim=True)
    sfeat = c(torch.cat([radial, rattr[:, :2]], dim=-1))
    t1 = hr_r + hc_c + sfeat @ c(w["e_w1"][2 * H:]) + c(w["e_b1"])
    ef_r = _silu(_silu(t1) @ c(w["e_w2"]) + c(w["e_b2"]))
    y2 = _silu(ef_r @ c(w["e_w3"]) + c(w["e_b3"]))
    g_r = (y2.to(torch.float32) @ w["e_w4"].T) * rm
    return cd_r, g_r, ef_r


def _virtual_and_update(h, x, v, X, Hv, agg, agg_h, nm, nattr, gvec, w,
                        cfg: StackConfig):
    """The post-aggregation EGCL section on one graph: virtual edges, the
    coordinate / velocity / gravity updates, the node and virtual feature
    updates (EGCLVel's math with the batch axis dropped).

    h [N,H] f32, x [N,3] f32, v [N,3] f32, X [3,C] f32, Hv [H,C] f32,
    agg [N,3] f32, agg_h [N,H] f32, nm [N,1] f32 node mask."""
    H, C = cfg.hidden, cfg.channels
    dt = _dt(cfg)
    N = h.shape[0]

    vcd = X[None, :, :] - x[:, :, None]                       # [N, 3, C]
    virtual_radial = torch.linalg.norm(vcd, dim=1, keepdim=True)  # [N, 1, C]

    cnt_n = torch.clamp(torch.sum(nm), min=1.0)
    coord_mean = torch.sum(x * nm, dim=0) / cnt_n             # [3]
    Xc = X - coord_mean[:, None]                              # [3, C]
    m_X = torch.einsum("dc,de->ce", Xc, Xc)                   # [C, C]

    v_in = torch.cat(
        [h[:, None, :].expand(N, C, H),
         Hv.T[None, :, :].expand(N, C, H),
         virtual_radial.transpose(1, 2),                      # [N, C, 1]
         m_X[None, :, :].expand(N, C, C)], dim=-1)
    vef = _mlp2(v_in, w["ev_k0"], w["ev_b0"], w["ev_k1"], w["ev_b1"], dt,
                act_last=True)                                # [N, C, H]
    vef = vef * nm[:, :, None].to(vef.dtype)

    x = x + agg
    phi_xv = _coord_head(vef, w["xv_k0"], w["xv_b0"], w["xv_k1"], dt)
    x = x + torch.mean(-vcd * phi_xv.transpose(1, 2), dim=-1)
    x = x + _mlp2(h, w["v_k0"], w["v_b0"], w["v_k1"], w["v_b1"],
                  dt).to(torch.float32) * v
    if cfg.has_gravity:
        x = x + _mlp2(h, w["g_k0"], w["g_b0"], w["g_k1"], w["g_b1"],
                      dt).to(torch.float32) * gvec
    x = x * nm

    trans_X = vcd * _coord_head(vef, w["X_k0"], w["X_b0"], w["X_k1"],
                                dt).transpose(1, 2)
    X = X + torch.sum(trans_X * nm[:, :, None], dim=0) / cnt_n  # [3, C]

    agg_v = torch.mean(vef, dim=1)                            # [N, H]
    n_in = [h, agg_h, agg_v]
    if cfg.node_attr_nf:
        n_in.append(nattr)
    out = _mlp2(torch.cat([a.to(torch.float32) for a in n_in], dim=-1),
                w["h_k0"], w["h_b0"], w["h_k1"], w["h_b1"], dt)
    h = (h + out) if cfg.residual else out * torch.ones_like(h)
    h = h * nm

    agg_Hv = torch.sum(vef.to(torch.float32) * nm[:, :, None],
                       dim=0) / cnt_n                         # [C, H]
    hv_in = torch.cat([Hv.T, agg_Hv], dim=-1)                 # [C, 2H]
    out_v = _mlp2(hv_in, w["hv_k0"], w["hv_b0"], w["hv_k1"], w["hv_b1"],
                  dt).T                                       # [H, C]
    Hv = (Hv + out_v) if cfg.residual else out_v * torch.ones_like(Hv)
    return h, x, X, Hv


def _segment_rows(data, idx, n):
    out = data.new_zeros((n,) + tuple(data.shape[1:]))
    return out.index_add_(0, idx, data)


def _layer(cfg: StackConfig, h, x, v, X, Hv, node_mask, node_attr, gravity,
           edge_arrs, remote_arrs, w, edge_pass):
    """One EGCL layer on one graph; ``edge_pass`` is the in-window pass
    (:func:`fused_edge_layer` or its plain version)."""
    H = cfg.hidden
    c = _cast(_dt(cfg))
    row_t, col_l, kblk, scal = edge_arrs
    rr, rc, rattr, rmask = remote_arrs
    N = x.shape[0]

    w1 = w["e_w1"]
    hr = c(h) @ c(w1[:H])
    hc = c(h) @ c(w1[H:2 * H])
    ew = EdgeWeights(ws=w1[2 * H:], b1=w["e_b1"], w2=w["e_w2"], b2=w["e_b2"],
                     w3=w["e_w3"], b3=w["e_b3"], w4=w["e_w4"])
    trans_sum, count, ef_sum = edge_pass(
        x, hr, hc, row_t, col_l, kblk, scal, ew, cfg.block, cfg.dtype_name)

    rr, rc = rr.long(), rc.long()
    rm = rmask[:, None]
    cd_r, g_r, ef_r = _remote_edge_math(x[rr], x[rc], hr[rr], hc[rc], rattr,
                                        rm, w, H, _dt(cfg))
    trans_sum = trans_sum + _segment_rows(cd_r * g_r, rr, N)
    count = count + _segment_rows(rmask, rr, N)
    ef_sum = ef_sum + _segment_rows(ef_r.to(torch.float32) * rm, rr, N)

    cnt = torch.clamp(count, min=1.0)[:, None]
    agg = trans_sum / cnt if cfg.coords_mean else trans_sum
    agg_h = ef_sum / cnt
    nm = node_mask.to(torch.float32)[:, None]
    return _virtual_and_update(h, x, v, X, Hv, agg, agg_h, nm, node_attr,
                               gravity, w, cfg)


def _layer_ref(cfg: StackConfig, h, x, v, X, Hv, node_mask, node_attr,
               gravity, edge_arrs, remote_arrs, w):
    """One layer whose in-window pass IS :func:`fused_edge_layer` (the CUDA
    kernels on the card, with their backward): what the stack's backward
    reruns and differentiates, as the JAX package's ``_layer_ref``."""
    return _layer(cfg, h, x, v, X, Hv, node_mask, node_attr, gravity,
                  edge_arrs, remote_arrs, w, fused_edge_layer)


def _check_stack(cfg: StackConfig, h0, edge_arrs, remote_arrs) -> int:
    """The megakernel's checks, all before any launch; returns the
    residency estimate."""
    N = h0.shape[0]
    _check_grid(N, cfg.block)
    if cfg.n_layers < 1:
        raise ValueError(
            f"fused_egnn_stack needs n_layers >= 1 (got {cfg.n_layers})")
    return check_stack_vmem(cfg, n_nodes=N, n_edges=edge_arrs[1].shape[0],
                            remote_pad=remote_arrs[0].shape[0])


def fused_egnn_stack_ref(cfg: StackConfig, h0, x0, v, X0, Hv0, node_mask,
                         node_attr, gravity, edge_arrs, remote_arrs, wstack):
    """Plain PyTorch version of the megakernel (same arguments as
    :func:`fused_egnn_stack`): the layer loop over the same math, with
    :func:`fused_edge_layer_ref` as the in-window pass. Returns
    ``((h, x, X, Hv), (ck_h [L,N,H], ck_x [L,N,3], ck_X [L,3,C],
    ck_Hv [L,H,C]))``, the checkpoints being each layer's INPUT state."""
    _check_stack(cfg, h0, edge_arrs, remote_arrs)
    f32 = torch.float32
    h, x, X, Hv = h0.to(f32), x0.to(f32), X0.to(f32), Hv0.to(f32)
    v = v.to(f32)
    cks = ([], [], [], [])
    for l in range(cfg.n_layers):
        for ck, s in zip(cks, (h, x, X, Hv)):
            ck.append(s)
        w = {k: a[l] for k, a in wstack.items()}
        h, x, X, Hv = _layer(cfg, h, x, v, X, Hv, node_mask, node_attr,
                             gravity, edge_arrs, remote_arrs, w,
                             fused_edge_layer_ref)
    return (h, x, X, Hv), tuple(torch.stack(ck) for ck in cks)


# ---------------------------------------------------------------- kernel

# the C entry point's operand order (csrc/fused_stack_fwd.cu, StackArgs):
# the stacked weights follow _PTRS, in _WKEYS order
_PTRS = ("row_t", "col_l", "kblk", "scal", "rr", "rc", "rattr", "rmask",
         "h0", "x0", "v", "X0", "Hv0", "nm", "nattr", "gvec",
         "S_h", "S_x", "S_X", "S_Hv", "hr", "hc", "agg", "rtr", "part_cm",
         "part_tX", "part_Hv")
_WKEYS = ("e_w1", "e_b1", "e_w2", "e_b2", "e_w3", "e_b3", "e_w4",
          "ev_k0", "ev_b0", "ev_k1", "ev_b1", "xv_k0", "xv_b0", "xv_k1",
          "X_k0", "X_b0", "X_k1", "v_k0", "v_b0", "v_k1", "v_b1",
          "h_k0", "h_b0", "h_k1", "h_b1", "hv_k0", "hv_b0", "hv_k1", "hv_b1",
          "g_k0", "g_b0", "g_k1", "g_b1")
_STACK_SIZES = frozenset((16, 32, 64))
_MAX_CHANNELS = 8
_NODE_TILE = 16   # nodes per node tile of the kernel's phases A and C


def _weight_keys(cfg: StackConfig):
    """The config's stacked weights, in the C entry point's order."""
    shapes = stack_weight_shapes(cfg)
    return [k for k in _WKEYS if k in shapes]


def _lib_fn():
    from distegnn_tpu_torch.ops.build import LIBRARIES

    fn = LIBRARIES.get("fused_stack_fwd").fused_stack_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_int, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
    return fn


def _graph(b, h0, x0, v, X0, Hv0, node_mask, node_attr, edge_arrs,
           remote_arrs):
    """Graph ``b`` of a batch's operands, in fused_egnn_stack's layout."""
    return (h0[b], x0[b], v[b], X0[b], Hv0[b], node_mask[b],
            node_attr[b] if node_attr is not None else None,
            tuple(a[b] for a in edge_arrs), tuple(a[b] for a in remote_arrs))


def _check_batch(cfg: StackConfig, h0, edge_arrs, remote_arrs) -> int:
    """The megakernel's checks for every graph of a batch (the residency
    check per graph, as a single-graph launch takes it), all before any
    launch; returns the per-graph residency estimate."""
    est = 0
    for b in range(h0.shape[0]):
        est = _check_stack(cfg, h0[b], tuple(a[b] for a in edge_arrs),
                           tuple(a[b] for a in remote_arrs))
    return est


def fused_egnn_stack_batch_ref(cfg: StackConfig, h0, x0, v, X0, Hv0,
                               node_mask, node_attr, gravity, edge_arrs,
                               remote_arrs, wstack):
    """Plain PyTorch version of the batched megakernel (same arguments as
    :func:`fused_egnn_stack_batch`): :func:`fused_egnn_stack_ref` graph by
    graph. Returns ``((h [B,N,H], x [B,N,3], X [B,3,C], Hv [B,H,C]),
    (ck_h [B,L,N,H], ck_x [B,L,N,3], ck_X [B,L,3,C], ck_Hv [B,L,H,C]))``."""
    _check_batch(cfg, h0, edge_arrs, remote_arrs)
    outs, cks = [], []
    for b in range(h0.shape[0]):
        g = _graph(b, h0, x0, v, X0, Hv0, node_mask, node_attr, edge_arrs,
                   remote_arrs)
        o, c = fused_egnn_stack_ref(cfg, *g[:7], gravity, *g[7:], wstack)
        outs.append(o)
        cks.append(c)
    return (tuple(torch.stack(t) for t in zip(*outs)),
            tuple(torch.stack(t) for t in zip(*cks)))


def _fused_egnn_stack_batch_cuda(cfg: StackConfig, h0, x0, v, X0, Hv0,
                                 node_mask, node_attr, gravity, edge_arrs,
                                 remote_arrs, wstack):
    """Launch ``csrc/fused_stack_fwd.cu`` once for a batch of graphs: the
    same results as :func:`fused_egnn_stack_batch_ref`."""
    _check_batch(cfg, h0, edge_arrs, remote_arrs)
    B, N, H = h0.shape
    C, L, A, T = cfg.channels, cfg.n_layers, cfg.node_attr_nf, cfg.block
    if H not in _STACK_SIZES:
        raise ValueError(f"fused_stack_fwd supports H in "
                         f"{sorted(_STACK_SIZES)}, got H={H}")
    if not 1 <= C <= _MAX_CHANNELS:
        raise ValueError(f"fused_stack_fwd supports 1 <= C <= "
                         f"{_MAX_CHANNELS}, got C={C}")
    dev = h0.device
    f32, i32 = torch.float32, torch.int32
    row_t, col_l, kblk, scal = edge_arrs
    rr, rc, rattr, rmask = remote_arrs
    E, R = col_l.shape[1], rr.shape[1]
    if (E % (N // T) or (E // (N // T)) % T or R % 64
            or T % _NODE_TILE):
        raise ValueError(f"layout mismatch: N={N} E={E} R={R} block={T}")

    def f(a):
        return a.to(f32).contiguous()

    ops = {"row_t": row_t.contiguous(), "col_l": col_l.contiguous(),
           "kblk": kblk.contiguous(), "scal": scal.contiguous(),
           "rr": rr.to(i32).contiguous(), "rc": rc.to(i32).contiguous(),
           "rattr": f(rattr[..., :2]), "rmask": f(rmask),
           "h0": f(h0), "x0": f(x0), "v": f(v), "X0": f(X0), "Hv0": f(Hv0),
           "nm": f(node_mask),
           "nattr": f(node_attr) if A else None,
           "gvec": f(gravity) if cfg.has_gravity else None}
    for name, dtype, shape in (
            ("row_t", i32, (B, E // T, T)), ("col_l", i32, (B, E, 1)),
            ("kblk", i32, (B, E, 1)), ("scal", f32, (B, E, XL)),
            ("rr", i32, (B, R)), ("rc", i32, (B, R)),
            ("rattr", f32, (B, R, 2)), ("rmask", f32, (B, R)),
            ("h0", f32, (B, N, H)), ("x0", f32, (B, N, 3)),
            ("v", f32, (B, N, 3)), ("X0", f32, (B, 3, C)),
            ("Hv0", f32, (B, H, C)), ("nm", f32, (B, N)),
            ("nattr", f32, (B, N, A)), ("gvec", f32, (3,))):
        if ops[name] is not None:
            _check(ops[name], name, dtype, shape, dev)
    shapes = stack_weight_shapes(cfg)
    wts = {}
    for k, (a, b) in shapes.items():
        wts[k] = f(wstack[k])
        _check(wts[k], k, f32, (L, a, b), dev)

    act = torch.bfloat16 if cfg.dtype_name == "bf16" else f32
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ntile = N // _NODE_TILE
    ops.update(
        S_h=torch.empty((B, L + 1, N, H), dtype=f32, device=dev),
        S_x=torch.empty((B, L + 1, N, 3), dtype=f32, device=dev),
        S_X=torch.empty((B, L + 1, 3, C), dtype=f32, device=dev),
        S_Hv=torch.empty((B, L + 1, H, C), dtype=f32, device=dev),
        hr=torch.empty((B, N, H), dtype=act, device=dev),
        hc=torch.empty((B, N, H), dtype=act, device=dev),
        agg=torch.empty((B, N, H + 8), dtype=f32, device=dev),
        rtr=torch.empty((B, N, 4), dtype=f32, device=dev),
        part_cm=torch.empty((2, B, ntile, 4), dtype=f32, device=dev),
        part_tX=torch.empty((B, ntile, 3 * C), dtype=f32, device=dev),
        part_Hv=torch.empty((B, ntile, C * H), dtype=f32, device=dev))
    ptrs = [ops[n].data_ptr() if ops[n] is not None else 0 for n in _PTRS]
    ptrs += [wts[k].data_ptr() if k in wts else 0 for k in _WKEYS]
    dims = [B, N, E, R, T, L, C, A, int(cfg.has_gravity), int(cfg.residual),
            int(cfg.coords_mean), n_sm]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    info = (ctypes.c_int * 3)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib_fn()(ctypes.addressof(c_ptrs), ctypes.addressof(c_dims), H,
                    int(cfg.dtype_name == "bf16"), ctypes.addressof(info),
                    stream)
    if err != 0:
        raise RuntimeError(f"fused_stack_fwd launch failed: CUDA error {err}")
    fused_egnn_stack.launches += 1
    fused_egnn_stack.last_launch = {"grid": info[0], "blocks_per_sm": info[1],
                                    "smem_bytes": info[2], "graphs": B}
    S_h, S_x, S_X, S_Hv = ops["S_h"], ops["S_x"], ops["S_X"], ops["S_Hv"]
    return ((S_h[:, L], S_x[:, L], S_X[:, L], S_Hv[:, L]),
            (S_h[:, :L], S_x[:, :L], S_X[:, :L], S_Hv[:, :L]))


class FusedEgnnStack(torch.autograd.Function):
    """The batched megakernel as an autograd node. The stacked weights come
    in as separate tensors (in ``_WKEYS`` order) so that their gradients
    reach the per-layer parameters they are stacked from."""

    @staticmethod
    def forward(ctx, cfg, h0, x0, v, X0, Hv0, node_mask, node_attr, gravity,
                edge_arrs, remote_arrs, *wlist):
        run = _on_device(_fused_egnn_stack_batch_cuda,
                         fused_egnn_stack_batch_ref, h0)
        keys = _weight_keys(cfg)
        wstack = dict(zip(keys, wlist))
        out, cks = run(cfg, h0, x0, v, X0, Hv0, node_mask, node_attr,
                       gravity, edge_arrs, remote_arrs, wstack)
        ctx.cfg, ctx.keys = cfg, keys
        ctx.consts = (node_mask, node_attr, gravity, edge_arrs, remote_arrs)
        ctx.save_for_backward(*cks, v, *wlist)
        return out

    @staticmethod
    def backward(ctx, dh, dx, dX, dHv):
        """The JAX reverse walk, graph by graph: each layer rerun from its
        checkpoint through ``_layer_ref`` (per layer and graph one forward
        and one backward launch of the fused edge kernels on the card) and
        its vector-Jacobian product taken."""
        cfg, keys = ctx.cfg, ctx.keys
        node_mask, node_attr, gravity, edge_arrs, remote_arrs = ctx.consts
        ck_h, ck_x, ck_X, ck_Hv, v, *wlist = ctx.saved_tensors
        d_in = [[], [], [], [], []]            # dh0, dx0, dv, dX0, dHv0
        dws = [[None] * cfg.n_layers for _ in keys]
        for b in range(v.shape[0]):
            g_dh, g_dx, g_dX, g_dHv = dh[b], dx[b], dX[b], dHv[b]
            g_dv = torch.zeros_like(v[b])
            arrs = (tuple(a[b] for a in edge_arrs),
                    tuple(a[b] for a in remote_arrs))
            nattr = node_attr[b] if node_attr is not None else None
            for l in reversed(range(cfg.n_layers)):
                with torch.enable_grad():
                    ins = [a.detach().requires_grad_() for a in
                           (ck_h[b, l], ck_x[b, l], v[b], ck_X[b, l],
                            ck_Hv[b, l])]
                    wl = [w[l].detach().requires_grad_() for w in wlist]
                    outs = _layer_ref(cfg, *ins, node_mask[b], nattr,
                                      gravity, *arrs, dict(zip(keys, wl)))
                    grads = torch.autograd.grad(
                        outs, ins + wl,
                        grad_outputs=(g_dh, g_dx, g_dX, g_dHv),
                        allow_unused=True)
                grads = [torch.zeros_like(a) if g is None else g
                         for g, a in zip(grads, ins + wl)]
                g_dh, g_dx, dv_l, g_dX, g_dHv = grads[:5]
                g_dv = g_dv + dv_l
                for acc, g in zip(dws, grads[5:]):
                    acc[l] = g if acc[l] is None else acc[l] + g
            for acc, g in zip(d_in, (g_dh, g_dx, g_dv, g_dX, g_dHv)):
                acc.append(g)
        dh0, dx0, dv, dX0, dHv0 = (torch.stack(a) for a in d_in)
        dw = [torch.stack(acc) for acc in dws]
        return (None, dh0, dx0, dv, dX0, dHv0, None, None, None, None, None,
                *dw)


def fused_egnn_stack_batch(cfg: StackConfig, h0, x0, v, X0, Hv0, node_mask,
                           node_attr, gravity, edge_arrs, remote_arrs,
                           wstack):
    """Run all L EGCL layers of a batch of B graphs in one megakernel
    launch.

    The arguments are :func:`fused_egnn_stack`'s with a leading batch axis
    on every per-graph operand (``h0`` [B, N, H], ``edge_arrs`` and
    ``remote_arrs`` as ``FastEGNN`` builds them for the batch); ``gravity``
    and the stacked weights are shared. Returns (h [B,N,H], x [B,N,3],
    X [B,3,C], Hv [B,H,C]) after L layers. The residency check runs per
    graph, before any launch; ``fused_egnn_stack.launches`` counts one per
    batch. Differentiable as :func:`fused_egnn_stack`; the backward walks
    each graph's layers in reverse."""
    return FusedEgnnStack.apply(cfg, h0, x0, v, X0, Hv0, node_mask,
                                node_attr, gravity, edge_arrs, remote_arrs,
                                *[wstack[k] for k in _weight_keys(cfg)])


def fused_egnn_stack(cfg: StackConfig, h0, x0, v, X0, Hv0, node_mask,
                     node_attr, gravity, edge_arrs, remote_arrs, wstack):
    """Run all L EGCL layers of one graph in one megakernel launch.

    Args:
      cfg         StackConfig
      h0          [N, H] f32 embedded node features
      x0, v       [N, 3] f32 coordinates (Morton-ordered, block-padded) and
                  velocities
      X0          [3, C] f32 initial virtual coordinates
      Hv0         [H, C] f32 initial virtual features
      node_mask   [N] f32
      node_attr   [N, A] f32 or None (cfg.node_attr_nf == 0)
      gravity     [3] f32 or None (cfg.has_gravity == False)
      edge_arrs   build_edge_blocks output (row_t, col_l, kblk, scal)
      remote_arrs (rr [R] i32, rc [R] i32, rattr [R, >=2] f32, rmask [R] f32)
      wstack      {key: [L, a, b]} stacked per-layer weights
                  (stack_weight_shapes layout)

    Returns (h [N,H], x [N,3], X [3,C], Hv [H,C]) after L layers.

    Differentiable in h0, x0, v, X0, Hv0 and the stacked weights; the
    batch-borne constants get no gradient. CUDA tensors launch the kernel (a
    failed build or launch raises; there is no fallback), CPU tensors run
    :func:`fused_egnn_stack_ref`. The residency check runs before either.
    It is :func:`fused_egnn_stack_batch` on a batch of one;
    ``fused_egnn_stack.launches`` counts kernel launches.
    """
    out = fused_egnn_stack_batch(
        cfg, h0[None], x0[None], v[None], X0[None], Hv0[None],
        node_mask[None], node_attr[None] if node_attr is not None else None,
        gravity, tuple(a[None] for a in edge_arrs),
        tuple(a[None] for a in remote_arrs), wstack)
    return tuple(a[0] for a in out)


fused_egnn_stack.launches = 0
fused_egnn_stack.last_launch = None
