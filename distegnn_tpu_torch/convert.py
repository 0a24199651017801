"""Parameter conversion from the JAX package's flax tree to the port's
``state_dict``, for every family of the factory.

Each port module mirrors its flax tree, so :func:`flax_layout` derives the
flax path of every parameter from the module itself (the class attributes
``FLAX_CHILD`` / ``FLAX_LIST`` / ``FLAX_PREFIX`` / ``FLAX_PARAM`` name what
differs), and ``params_from_jax(tree, model)`` reads the tree there. A
FastEGNN tree (``edge_impl`` 'fused', 'fused_stack' or 'plain'; a
'fused_stack' tree is the 'fused' tree) also converts without the model:

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

:func:`checkpoint_from_jax` continues a JAX training checkpoint in the port
(see its docstring for the optax state's mapping).
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Mapping, Optional, Tuple

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


def params_from_jax(flax_params: Mapping,
                    model: Optional[torch.nn.Module] = None
                    ) -> Dict[str, torch.Tensor]:
    """Flax params (numpy leaves, with or without the top-level ``params``
    key) -> the port's ``state_dict``. With ``model`` (any family of the
    factory, or a module of one) the tree is read at the flax path of each
    of its parameters (:func:`flax_layout`); without it the tree is a
    FastEGNN's, told apart by its own keys."""
    p = flax_params.get("params", flax_params)
    if model is not None:
        return _from_layout(p, flax_layout(model))
    if "embedding_in" not in p or "virtual_node_feat" not in p or (
            "gcl_0" in p and "phi_v" not in p["gcl_0"]):
        raise ValueError(
            "not a FastEGNN flax tree: pass the port model it belongs to "
            "(params_from_jax(tree, model))")
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


# ---- every family: the flax path of each port parameter ---------------------

def flax_layout(module: torch.nn.Module, prefix: str = "",
                path: Tuple[str, ...] = ()) -> List[Tuple[str, tuple, bool]]:
    """(port parameter name, its flax path under ``params``, whether the
    flax leaf is the transpose) for every parameter of ``module``.

    The port's modules mirror the flax trees: a child keeps its flax name
    unless its class maps it (``FLAX_CHILD``: child -> path segments); a
    ``ModuleList`` child ``name.i`` is flax's ``name_i`` unless the class
    names the list otherwise (``FLAX_LIST``, MLP's ``TorchDense_{}``); a
    class may nest all of its own entries below ``FLAX_PREFIX`` (CoordMLP's
    ``MLP_0``), and map its own parameters (``FLAX_PARAM``: the TorchDense
    and Dense kernels, transposed from ``nn.Linear``'s [out, in])."""
    cls = type(module)
    base = path + tuple(getattr(cls, "FLAX_PREFIX", ()))
    own = getattr(cls, "FLAX_PARAM", {})
    rows = []
    for name, _ in module.named_parameters(recurse=False):
        seg, transposed = own.get(name, ((name,), False))
        rows.append((prefix + name, base + tuple(seg), transposed))
    child_map = getattr(cls, "FLAX_CHILD", {})
    lists = getattr(cls, "FLAX_LIST", {})
    for name, child in module.named_children():
        if isinstance(child, torch.nn.ModuleList):
            fmt = lists.get(name, name + "_{}")
            for i, c in enumerate(child):
                rows += flax_layout(c, f"{prefix}{name}.{i}.",
                                    base + (fmt.format(i),))
        else:
            rows += flax_layout(child, f"{prefix}{name}.",
                                base + tuple(child_map.get(name, (name,))))
    return rows


def _leaf(tree: Mapping, path: Tuple[str, ...]):
    node = tree
    for k in path:
        if not isinstance(node, Mapping) or k not in node:
            raise KeyError(f"flax path {'/'.join(path)} is not in the tree")
        node = node[k]
    return node


def _from_layout(p: Mapping, layout) -> Dict[str, torch.Tensor]:
    out = {}
    for name, path, transposed in layout:
        a = np.asarray(_leaf(p, path), np.float32)
        out[name] = torch.from_numpy(np.array(a.T if transposed else a,
                                              order="C"))
    return out


# ---- JAX training checkpoints ------------------------------------------------

def _jax_layout(model: torch.nn.Module) -> List[Tuple[str, tuple, bool]]:
    """(port parameter name, flax path, transposed) in the order of
    ``jax.tree.leaves`` of the flax tree: its dict keys sorted at every
    level, i.e. the paths sorted."""
    return sorted(flax_layout(model), key=lambda r: r[1])


def _nest(layout, leaves) -> dict:
    """A flax-shaped nested dict {"params": ...} of ``leaves`` placed at
    the layout's paths."""
    root: dict = {}
    for (_, path, _), leaf in zip(layout, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(leaf)
    return {"params": root}


def _read_jax_payload(path: str) -> dict:
    """A JAX checkpoint's payload (a pickle of numpy leaves), verified
    against its directory's manifest like the port's own files."""
    from distegnn_tpu_torch.train.checkpoint import (CheckpointCorruptError,
                                                     verified_blob)

    blob = verified_blob(path)
    try:
        payload = pickle.loads(blob)
    except (EOFError, pickle.UnpicklingError, AttributeError, ImportError,
            IndexError, TypeError, ValueError) as e:
        raise CheckpointCorruptError(path, f"unpickle failed: {e!r}") \
            from None
    if not isinstance(payload, dict) or any(
            k not in payload for k in ("epoch", "params_leaves",
                                       "opt_state_leaves", "step")):
        raise CheckpointCorruptError(path, "not a JAX training checkpoint")
    return payload


def params_from_checkpoint(path: str,
                           model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters of a JAX training checkpoint as ``model``'s
    ``state_dict`` (its optimizer state ignored): what serving loads from a
    candidate the JAX trainer published. Raises CheckpointCorruptError on a
    file that is not a JAX checkpoint, ValueError on another architecture."""
    payload = _read_jax_payload(path)
    layout = _jax_layout(model)
    leaves = payload["params_leaves"]
    if len(leaves) != len(layout):
        raise ValueError(f"{path}: {len(leaves)} parameter arrays, the model "
                         f"has {len(layout)}: another architecture or config")
    params = params_from_jax(_nest(layout, leaves), model)
    own = model.state_dict()
    for name, t in params.items():
        if name not in own or tuple(own[name].shape) != tuple(t.shape):
            raise ValueError(f"{path}: parameter {name} of shape "
                             f"{tuple(t.shape)} does not fit the model")
    return {name: params.get(name, own[name]) for name in own}


def checkpoint_from_jax(path: str, state, config=None):
    """Continue a JAX training checkpoint (``distegnn_tpu.train.checkpoint
    .save_checkpoint``: a pickle of numpy leaves; read without jax or
    optax) in the port: its parameters, its optimizer state and its resume
    coordinates are loaded into ``state`` (a ``TrainState`` built from the
    same config), in place. Returns a ``RestoredRun``.

    ``params_leaves`` are the flax tree's leaves in sorted-path order and go
    through :func:`params_from_jax`. ``opt_state_leaves`` are those of
    ``train/step.py``'s ``make_optimizer`` chain: [clip] ->
    [add_decayed_weights] -> scale_by_adam (count, mu, nu) ->
    scale_by_learning_rate ([a count] for the cosine schedule), wrapped in
    ``optax.MultiSteps`` (mini_step, gradient_step, the inner state,
    acc_grads) when accumulating; the clip and the decay hold no leaves.
    They map to: mu / nu -> Adam's ``exp_avg`` / ``exp_avg_sq``, count ->
    Adam's ``step``, mini_step -> ``micro``, gradient_step -> ``updates``,
    acc_grads -> ``p.grad``. MultiSteps keeps the running mean of the
    micro-gradients of the loss, the port the sum of the micro-gradients
    of loss / k: ``p.grad = acc_grads * mini_step / k``. The divergence
    rollback's learning-rate scale is not saved (as in JAX)."""
    from distegnn_tpu_torch.train.checkpoint import (RestoredRun,
                                                     check_mesh_restore_compat)

    payload = _read_jax_payload(path)
    if config is not None:
        check_mesh_restore_compat(payload, config)
    model, opt = state.model, state.optimizer
    layout = _jax_layout(model)
    n = len(layout)
    leaves = payload["params_leaves"]
    if len(leaves) != n:
        raise ValueError(f"{path}: {len(leaves)} parameter arrays, the model "
                         f"has {n}: another architecture or config")
    k = opt.accumulation_steps
    cosine = opt.scheduler == "cosine"
    ol = list(payload["opt_state_leaves"])
    want = (2 if k > 1 else 0) + 1 + 2 * n + int(cosine) + (n if k > 1
                                                           else 0)
    if len(ol) != want:
        raise ValueError(
            f"{path}: {len(ol)} optimizer arrays, the optimizer of "
            f"accumulation_steps={k}, scheduler={opt.scheduler!r} has {want}")
    micro, updates = (int(ol[0]), int(ol[1])) if k > 1 else (0, None)
    inner = ol[2:] if k > 1 else ol
    count, mu, nu = int(inner[0]), inner[1:1 + n], inner[1 + n:1 + 2 * n]
    rest = inner[1 + 2 * n:]
    if cosine:
        if int(rest[0]) != count:
            raise ValueError(f"{path}: the schedule count {int(rest[0])} "
                             f"differs from Adam's {count}")
        rest = rest[1:]
    acc = rest if k > 1 else None
    updates = count if updates is None else updates

    def to_port(arrays) -> Dict[str, torch.Tensor]:
        return params_from_jax(_nest(layout, arrays), model)

    params = to_port(leaves)
    own = dict(model.named_parameters())
    for name, t in params.items():
        if name not in own or tuple(own[name].shape) != tuple(t.shape):
            raise ValueError(f"{path}: parameter {name} of shape "
                             f"{tuple(t.shape)} does not fit the model")
    m1, m2 = to_port(mu), to_port(nu)
    index = {p: i for i, p in enumerate(opt.params)}
    adam_sd = opt.adam.state_dict()
    adam_sd["state"] = {
        index[own[name]]: {"step": torch.tensor(float(count)),
                           "exp_avg": m1[name], "exp_avg_sq": m2[name]}
        for name in params}
    grads = None
    if micro:
        g = to_port([np.asarray(a, np.float32) * np.float32(micro / k)
                     for a in acc])
        grads = [g[name] for name, p in model.named_parameters()
                 if p.requires_grad]
    with torch.no_grad():
        for name, t in params.items():
            own[name].copy_(t)
    opt.load_state_dict({"adam": adam_sd, "micro": micro, "updates": updates,
                         "grads": grads})
    state.step = int(payload["step"])
    return RestoredRun(state=state, epoch=int(payload["epoch"]),
                       step_in_epoch=int(payload.get("step_in_epoch") or 0),
                       losses=payload.get("losses") or {},
                       seed=payload.get("seed"), path=path)
