"""The port's scanned epoch (distegnn_tpu_torch/train/scan_epoch.py) on the
CPU, on JAX's toy set of tests/test_scan_epoch.py: 12 fully connected
graphs of 16 nodes, FastEGNN at H=8, L=2, C=2.

On the CPU the runner runs the per-step body it captures on the card,
without capture, so against the port's eager loop it must be the same
training run bit for bit: losses, parameters and eval, with clip,
accumulation and the MMD on its sampling branch (the uniforms drawn by the
eager loop's ``torch.rand`` call, outside the step). Against JAX's
``ScanEpochRunner`` (the parameters carried by ``convert.params_from_jax``)
it must agree to 1e-5 of the parameters' scale, with the MMD on its
deterministic branch (the two packages' generators differ). A mid-epoch
resume, a rollback under a live runner, the cosine schedule, the
``scan_epochs`` policy and the distributed runner over gloo ranks at
(D, P) = (1, 2) and (2, 1) are held against the eager loop.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os
from unittest import mock

import numpy as np
import pytest
import torch

from distegnn_tpu_torch.data.loader import GraphDataset, GraphLoader
from distegnn_tpu_torch.models.fast_egnn import FastEGNN
from distegnn_tpu_torch.train import scan_epoch
from distegnn_tpu_torch.train.scan_epoch import ScanEpochRunner
from distegnn_tpu_torch.train.step import (TrainState, make_eval_step,
                                           make_optimizer, make_train_step)
from distegnn_tpu_torch.train.trainer import (restore_state, run_epoch_eval,
                                              run_epoch_train, snapshot_state)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 11
MODEL = dict(node_feat_nf=1, edge_attr_nf=2, hidden_nf=8, virtual_channels=2,
             n_layers=2)


def toy_graphs(rng, n_graphs=12, n=16):
    """JAX's ``_toy_dataset`` graphs (tests/test_scan_epoch.py)."""
    graphs = []
    for _ in range(n_graphs):
        loc = rng.normal(size=(n, 3)).astype(np.float32)
        vel = rng.normal(size=(n, 3)).astype(np.float32)
        row, col = np.nonzero(~np.eye(n, dtype=bool))
        graphs.append({
            "node_feat": np.linalg.norm(vel, axis=1,
                                        keepdims=True).astype(np.float32),
            "loc": loc, "vel": vel, "target": loc + 0.1 * vel,
            "edge_index": np.stack([row, col]).astype(np.int64),
            "edge_attr": np.ones((row.size, 2), np.float32)})
    return graphs


@pytest.fixture(scope="module")
def toy():
    return GraphDataset(toy_graphs(np.random.default_rng(7)))


def _loader(ds, shuffle, batch_size=4):
    return GraphLoader(ds, batch_size=batch_size, shuffle=shuffle, seed=SEED)


def _init_sd():
    return FastEGNN(**MODEL, generator=torch.Generator().manual_seed(0)
                    ).state_dict()


def _state(sd, k=2, samples=2, scheduler="None", total_steps=None):
    """A TrainState from ``sd`` with its steps: clip 0.3, ``k``-step
    accumulation, MMD weight 0.01 over ``samples`` (2 x C=2 < 16 nodes:
    the sampling branch)."""
    model = FastEGNN(**MODEL)
    model.load_state_dict(sd)
    opt = make_optimizer(model.parameters(), 1e-3, weight_decay=1e-4,
                         clip_norm=0.3, accumulation_steps=k,
                         total_steps=total_steps, scheduler=scheduler)
    step = make_train_step(model, opt, 0.01, 1.5, samples)
    return TrainState(model, opt), step, make_eval_step(model)


def _eager(ds, sd, epochs, start=1, state=None, **kw):
    if state is None:
        state, step, ev = _state(sd, **kw)
    else:
        state, (step, ev) = state
    losses = []
    for epoch in range(start, start + epochs):
        state, loss = run_epoch_train(step, state, _loader(ds, True), SEED,
                                      epoch, CPU)
        losses.append(loss)
    return state, losses, run_epoch_eval(ev, _loader(ds, False), CPU)


def _runner(ds, step, ev):
    return ScanEpochRunner(step, ev, _loader(ds, True), SEED,
                           loader_valid=_loader(ds, False),
                           loader_test=_loader(ds, False))


def _assert_same(a, b):
    """Bitwise equal parameters, optimizer moments and counters."""
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    assert (a.optimizer.updates, a.optimizer.micro, a.step) == \
        (b.optimizer.updates, b.optimizer.micro, b.step)
    for pa, pb in zip(a.optimizer.params, b.optimizer.params):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.adam.state[pa][key],
                               b.optimizer.adam.state[pb][key]), key


def test_scanned_epochs_equal_the_eager_loop_bitwise(toy):
    """(a) 3 epochs, clip, accumulation 2, MMD on its sampling branch."""
    sd = _init_sd()
    state_a, losses_a, eval_a = _eager(toy, sd, 3)
    state_b, step, ev = _state(sd)
    runner = _runner(toy, step, ev)
    assert runner.u is not None and runner.u.shape == (4, 4)
    losses_b = []
    for epoch in (1, 2, 3):
        state_b, loss = runner.train_epoch(state_b, epoch)
        losses_b.append(loss)
    assert losses_b == losses_a
    assert runner.eval_epoch(state_b.model, "valid") == eval_a
    assert runner.eval_epoch(state_b.model, "test") == eval_a
    _assert_same(state_a, state_b)
    # nothing captured on the CPU: the bodies ran, three epochs of 3 steps
    assert runner.graphs is None and runner.launches() == {}
    assert runner.replays == {"update": 4, "accumulate": 5,
                              "eval_valid": 3, "eval_test": 3}


@pytest.mark.parametrize("case", ["rollback", "cosine"])
def test_rollback_and_cosine_under_a_live_runner(toy, case):
    """(d) A rollback (``restore_state`` to an epoch-1 snapshot, then a
    lowered ``lr_scale``) under a live runner equals the eager loop's; so
    does the cosine schedule, whose rate changes every update."""
    sd = _init_sd()
    kw = (dict(scheduler="cosine", total_steps=3) if case == "cosine"
          else {})
    runs = []
    for scanned in (False, True):
        state, step, ev = _state(sd, **kw)
        runner = _runner(toy, step, ev) if scanned else None

        def epoch_of(st, e):
            if runner is not None:
                return runner.train_epoch(st, e)
            return run_epoch_train(step, st, _loader(toy, True), SEED, e,
                                   CPU)

        state, _ = epoch_of(state, 1)
        losses = []
        if case == "rollback":
            snap = snapshot_state(state)
            state, _ = epoch_of(state, 2)
            restore_state(state, snap)
            state.optimizer.lr_scale = 0.25
        for e in (2, 3):
            state, loss = epoch_of(state, e)
            losses.append(loss)
        runs.append((state, losses))
    (a, la), (b, lb) = runs
    assert la == lb
    _assert_same(a, b)
    if case == "cosine":
        assert a.optimizer.updates > a.optimizer.total_steps


def test_scan_enabled_policy():
    """(e) False / True; 'auto' off on the CPU and, on the card, on at
    most 0.4 of its memory."""
    f = scan_epoch.scan_enabled
    assert f(True, 1 << 40, CPU) and not f(False, 0, CPU)
    assert not f("auto", 0, CPU) and not f("yes", 0, CPU)
    props = mock.Mock(total_memory=10_000)
    with mock.patch("torch.cuda.get_device_properties",
                    return_value=props):
        assert f("auto", 4000, "cuda:0")
        assert not f("auto", 4001, "cuda:0")
        assert not f(False, 0, "cuda:0") and f(True, 1 << 40, "cuda:0")


def test_staged_stack_is_the_loaders_batches(toy):
    """The staged stack picked by the loader's order is the loader's own
    batches, and its footprint is what dataset_nbytes says."""
    ld = _loader(toy, True)
    data = scan_epoch.stack_dataset(ld)
    ld.set_epoch(2)
    order = ld._order()
    for b, batch in enumerate(ld):
        got = scan_epoch.pick(data, torch.from_numpy(order[4 * b:4 * b + 4]))
        for k, v in vars(batch).items():
            w = getattr(got, k)
            assert (torch.equal(v, w) if isinstance(v, torch.Tensor)
                    else v == w), k
    assert scan_epoch.dataset_nbytes(ld) == sum(
        t.nbytes for t in vars(data).values() if isinstance(t, torch.Tensor))


def test_mmd_draw_only_on_the_sampling_branch(toy):
    """Every real node used once (16 <= 8 x C): no draw, no buffer."""
    state, step, ev = _state(_init_sd(), samples=8)
    assert _runner(toy, step, ev).u is None


def _train_config(tmp_path, epochs=3):
    from distegnn_tpu_torch.config import load_config

    return load_config(os.path.join(REPO, "configs", "nbody_serve.yaml"), {
        "train.epochs": epochs, "log.test_interval": 1,
        "log.log_dir": str(tmp_path), "train.early_stop": 100,
        "train.scan_epochs": True, "obs.enable": False, "seed": SEED})


def test_trainer_resumes_a_partial_epoch_eagerly_then_scans(toy, tmp_path):
    """(c) through ``trainer.train``: a run stopped after 2 steps of epoch
    1, checkpointed and resumed (the rest of epoch 1 eagerly, then scanned
    epochs) ends at the parameters and the log of the uninterrupted
    scanned run."""
    from distegnn_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                     save_checkpoint)
    from distegnn_tpu_torch.train.trainer import PreemptionGuard, train

    sd = _init_sd()
    cfg = _train_config(tmp_path / "a")
    state_a, step_a, ev_a = _state(sd)
    state_a, _, best_a, log_a = train(
        state_a, step_a, ev_a, _loader(toy, True), _loader(toy, False),
        _loader(toy, False), cfg, CPU, scan_runner=_runner(toy, step_a, ev_a))

    state_b, step_b, _ = _state(sd)
    guard = PreemptionGuard()
    guard.stop_agreed = lambda: state_b.step >= 2
    state_b, _ = run_epoch_train(step_b, state_b, _loader(toy, True), SEED,
                                 1, CPU, guard=guard)
    assert guard.steps_done == 2 and state_b.optimizer.micro == 0
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, state_b, 0, step_in_epoch=2)
    state_c, step_c, ev_c = _state(_init_sd())
    runner = _runner(toy, step_c, ev_c)
    state_c, epoch, _ = restore_checkpoint(path, state_c)
    assert epoch == 0
    steps = []
    state_c, _, best_c, log_c = train(
        state_c, step_c, ev_c, _loader(toy, True), _loader(toy, False),
        _loader(toy, False), _train_config(tmp_path / "c"), CPU,
        start_step_in_epoch=2, scan_runner=runner,
        on_step=lambda e, s, m: steps.append((e, s)))
    # the eager remainder of epoch 1 calls on_step; the scans do not
    assert steps == [(1, 2)]
    assert runner.replays["update"] + runner.replays["accumulate"] == 6
    _assert_same(state_a, state_c)
    assert log_c["loss"] == log_a["loss"] and best_c["loss_valid"] == \
        best_a["loss_valid"]
    assert log_c["loss_train"][1:] == log_a["loss_train"][1:]


def test_scan_runner_matches_the_jax_runner(toy):
    """(b) The port's runner against JAX's ``ScanEpochRunner`` from the
    same parameters (``params_from_jax``): 2 epochs, clip, accumulation 2,
    weight decay, MMD on its deterministic branch; losses and eval to
    1e-5 relative, parameters to 1e-5 of their scale."""
    import jax
    from distegnn_tpu.data.loader import GraphDataset as JaxGraphDataset
    from distegnn_tpu.data.loader import GraphLoader as JaxGraphLoader
    from distegnn_tpu.models.fast_egnn import FastEGNN as JaxFastEGNN
    from distegnn_tpu.train import TrainState as JaxTrainState
    from distegnn_tpu.train import make_eval_step as jax_eval_step
    from distegnn_tpu.train import make_optimizer as jax_optimizer
    from distegnn_tpu.train import make_train_step as jax_train_step
    from distegnn_tpu.train.scan_epoch import \
        ScanEpochRunner as JaxScanEpochRunner

    from distegnn_tpu_torch.convert import params_from_jax

    jds = JaxGraphDataset(toy_graphs(np.random.default_rng(7)))
    mk = lambda shuffle: JaxGraphLoader(jds, batch_size=4, shuffle=shuffle,
                                        seed=SEED)
    jm = JaxFastEGNN(**MODEL)
    tx = jax_optimizer(1e-3, weight_decay=1e-4, clip_norm=0.3,
                       accumulation_steps=2)
    params = jm.init(jax.random.PRNGKey(0), next(iter(mk(False))))
    jrun = JaxScanEpochRunner(
        jax.jit(jax_train_step(jm, tx, mmd_weight=0.01, mmd_sigma=1.5,
                               mmd_samples=8)),
        jax.jit(jax_eval_step(jm)), mk(True), SEED, loader_valid=mk(False))
    jstate = JaxTrainState.create(params, tx)
    jlosses = []
    for epoch in (1, 2):
        jstate, loss = jrun.train_epoch(jstate, epoch)
        jlosses.append(float(loss))
    jeval = jrun.eval_epoch(jstate.params, "valid")
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))

    state, step, ev = _state(params_from_jax(jax.tree.map(np.asarray,
                                                          params)),
                             samples=8)
    runner = _runner(toy, step, ev)
    losses = []
    for epoch in (1, 2):
        state, loss = runner.train_epoch(state, epoch)
        losses.append(loss)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(runner.eval_epoch(state.model, "valid"),
                               jeval, rtol=1e-5)
    got = state.model.state_dict()
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for k, v in want.items():
        err = float(np.abs(got[k].numpy() - v.numpy()).max())
        assert err <= 1e-5 * scale, f"{k}: {err:.3e} > {1e-5 * scale:.3e}"


def _part_graphs(rng, n_parts, n_graphs=8, n=12):
    """JAX's ``_part_datasets`` (tests/test_scan_epoch.py): independent
    per-part toy shards sharing each graph's global loc_mean."""
    parts = [toy_graphs(rng, n_graphs=n_graphs, n=n) for _ in range(n_parts)]
    for i in range(n_graphs):
        mean = np.mean([p[i]["loc"] for p in parts], axis=(0, 1))
        for p in parts:
            p[i]["loc_mean"] = mean.astype(np.float32)
    return parts


@pytest.mark.parametrize("mesh", [(1, 2, 1), (2, 1, 1)],
                         ids=["graph2", "data2"])
def test_distributed_scan_equals_the_eager_loop(tmp_path, mesh):
    """(f) The eager distributed loop on ``DistributedScanRunner``s
    against it on the rank's loaders, on 2 gloo ranks, both runs inside
    the same ranks: 2 epochs, accumulation 2, MMD on its sampling branch;
    losses, eval and parameters bitwise, and the parameters replicated
    over the ranks."""
    import torch_mesh_worker as worker

    parts = _part_graphs(np.random.default_rng(21), mesh[1])
    sd = {k: v.numpy() for k, v in FastEGNN(
        **MODEL, generator=torch.Generator().manual_seed(0)).state_dict()
          .items()}
    job = dict(kind="scan", shards=parts, batch_size=2, seed=13, mesh=mesh,
               model=MODEL, state_dict=sd,
               hyper=dict(lr=1e-3, k=2, mmd_weight=0.01, mmd_samples=2))
    ctx = worker.start({"scan": job}, mesh, str(tmp_path))
    ranks = worker.collect(ctx, 2, str(tmp_path))
    for res in ranks:
        a, b = res["scan"]["eager"], res["scan"]["scan"]
        assert a["losses"] == b["losses"] and a["eval"] == b["eval"]
        assert all(np.isfinite(a["losses"]))
        for k, v in a["params"].items():
            np.testing.assert_array_equal(b["params"][k], v, err_msg=k)
            np.testing.assert_array_equal(
                ranks[0]["scan"]["scan"]["params"][k], b["params"][k])
    assert ranks[0]["scan"]["eager"]["params"]["virtual_node_feat"].any()


def test_auto_budget_sums_the_ranks_on_one_card(tmp_path):
    """(e) 'auto' in distribute mode: 2 gloo ranks on one card (as the
    ranks of one machine share it) hold the sum of their staged bytes to
    the card's budget (0.4 of a patched 10000 bytes): 3000 each fits
    alone, 6000 together does not."""
    import torch_mesh_worker as worker

    job = dict(kind="card", nbytes=[3000, 3000], total_memory=10_000)
    ctx = worker.start({"card": job}, (1, 2, 1), str(tmp_path))
    ranks = worker.collect(ctx, 2, str(tmp_path))
    for res in ranks:
        assert res["card"] == {"card": 6000, "alone": True, "auto": False}
