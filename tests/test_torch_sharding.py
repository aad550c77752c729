"""Pixel sharding over torch.distributed (parallel/sharding.py): sharded
renders against single-process wavefront renders, the sharded history
train step against a single process, and the sharded adaptive planners
against the JAX package's.

A world of one runs in this process on an in-process store; the 2-rank
runs start two gloo processes (tests/torch_shard_worker.py) that meet
through a file:// store under tmp_path, each with a timeout. The single
process reference is `Renderer(route="wavefront")`: the ranks' draws are
the whole frame's, sliced (ops/wavefront.rand_planes), so the images agree
to 1e-5, as JAX's tests/test_sharding.py holds its sharded renders.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu.render import adaptive as JA
from project3_cuda_path_tracer_tpu_torch import Renderer
from project3_cuda_path_tracer_tpu_torch.models import inverse as inv
from project3_cuda_path_tracer_tpu_torch.parallel import sharding
from project3_cuda_path_tracer_tpu_torch.render import adaptive as PA

import torch_shard_worker as W

torch.set_num_threads(2)

ATOL = 1e-5
WORKER_TIMEOUT = 300


@pytest.fixture
def world1():
    """A world of one on an in-process store, torn down after the test."""
    sharding.init_distributed("gloo")
    try:
        yield
    finally:
        sharding.shutdown()


def single_image(scene, iters=W.ITERS, seed=5):
    r = Renderer(scene, device="cpu", route="wavefront")
    r.render(iters, seed=seed)
    return r.image()


@pytest.mark.parametrize("case", sorted(W.cases()))
def test_world1_matches_single_process(case, world1):
    """Each case (cornell under both samplers, cornell with NEE and
    Russian roulette, a mesh scene) in a world of one."""
    r = sharding.ShardedRenderer(W.cases()[case](), device="cpu")
    assert r.world == 1 and r.route == "wavefront"
    r.render(W.ITERS, seed=5)
    np.testing.assert_allclose(r.image(), single_image(W.cases()[case]()),
                               atol=ATOL)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 2-rank gloo run's results (rank 0's npz)."""
    tmp = tmp_path_factory.mktemp("gloo")
    out = tmp / "out.npz"
    init = tmp / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, W.__file__, str(init), str(r), "2", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=WORKER_TIMEOUT)
            logs.append(err.decode()[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), logs
    return dict(np.load(out))


@pytest.mark.parametrize("case", sorted(W.cases()))
def test_two_ranks_match_single_process(case, two_ranks):
    """Each case rendered by two gloo ranks, 8 or 16 rows each, gathered:
    the single-process image to 1e-5."""
    got = two_ranks["img_" + case]
    want = single_image(W.cases()[case]())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def _single_train(scene, seed=4):
    """The single-process history loss and gradients on the worker's
    inputs (models/inverse.history_residual_grad_loss)."""
    cfg = inv.train_config(scene)
    params = inv.params_from_scene(scene, "cpu")
    target, resid = W.train_inputs(scene)
    tables = sharding.shard_scene(scene, "cpu")[0]
    loss, _ = inv.history_residual_grad_loss(
        params, tables[2], scene.meshes, tables[3],
        inv.step_generator(seed, 0, "cpu"), cfg, target, resid)
    return loss.detach(), inv._grads(loss, inv.param_leaves(params))


def _assert_train_close(loss, grads, want_loss, want_grads):
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert (g is None) == (w is None), i
        if w is not None:
            np.testing.assert_allclose(np.asarray(g), w.numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=str(i))


def test_sharded_train_step_world1(world1):
    """The sharded history loss (normalised by the global pixel count)
    and its all-reduced gradients in a world of one."""
    scene = W.sized("cornell")
    loss, grads = W.sharded_train(scene)
    _assert_train_close(loss, [None if g is None else g.numpy()
                               for g in grads], *_single_train(scene))


def test_sharded_train_step_two_ranks(two_ranks):
    """Two ranks' loss shares and gradients, summed by all_reduce: the
    single process's loss and gradients."""
    want_loss, want_grads = _single_train(W.sized("cornell"))
    grads = [two_ranks.get(f"train_grad_{i}")
             for i in range(len(want_grads))]
    _assert_train_close(two_ranks["train_loss"], grads, want_loss,
                        want_grads)


def test_sharded_train_step_updates_like_single(world1):
    """make_train_step_sharded's step (world of one): the same loss and
    the same parameters after Adam as models/inverse.make_train_step."""
    scene = W.sized("cornell")
    target, resid = W.train_inputs(scene)
    cfg, step = sharding.make_train_step_sharded(scene, "cpu")
    p1 = inv.params_from_scene(scene, "cpu")
    s1 = inv.optim.init(inv.param_leaves(p1))
    p1, s1, _, l1 = step(p1, s1, resid, inv.step_generator(1, 0, "cpu"),
                         target)
    tables = sharding.shard_scene(scene, "cpu")[0]
    single = inv.make_train_step(tables[2], scene.meshes, tables[3],
                                 inv.train_config(scene), history=True)
    p2 = inv.params_from_scene(scene, "cpu")
    s2 = inv.optim.init(inv.param_leaves(p2))
    p2, s2, _, l2 = single(p2, s2, resid, inv.step_generator(1, 0, "cpu"),
                           target)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for a, b in zip(inv.param_leaves(p1), inv.param_leaves(p2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_plan_epoch_sharded_matches_jax(ndev):
    """The per-block apportionment bit for bit with the JAX planner on
    random running sums."""
    rng = np.random.default_rng(ndev)
    h, w = 16, 12
    accum = rng.random((h, w, 3)).astype(np.float32) * 4
    accum2 = rng.random((h, w)).astype(np.float32) * 9
    count = rng.integers(1, 9, (h, w)).astype(np.float64)
    got = PA.plan_epoch_sharded(accum, accum2, count, ndev)
    want = JA.plan_epoch_sharded(accum, accum2, count, ndev)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(wv))
    # every path's pixel lies in its own block of rows
    rows = h // ndev
    pix = got[0].numpy()
    blk = np.repeat(np.arange(ndev), rows * w)
    assert ((pix // w) // rows == blk).all()


@pytest.mark.parametrize("tile", [0, 4])
def test_identity_plan_sharded_matches_jax(tile):
    for ndev in (1, 2):
        got = PA.identity_plan_sharded(8, 16, ndev, tile)
        want = JA.identity_plan_sharded(8, 16, ndev, tile)
        for g, wv in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(wv))


def test_indivisible_height_rejected(world1):
    with pytest.raises(ValueError, match="divisible"):
        sharding.row_block(15, 2, 0)
    assert sharding.row_block(16, 2, 1) == (8, 16)


def test_restir_dropped_under_sharding(world1, capsys):
    """ReSTIR is single-process only: the sharded renderer drops it on one
    `features dropped` line and keeps NEE."""
    scene = W.sized("cornell", nee=True, restir=4)
    r = sharding.ShardedRenderer(scene, device="cpu")
    assert not r.cfg.restir and r.cfg.nee and r.reservoir is None
    assert "features dropped: restir" in capsys.readouterr().err
    r.render(1)
    assert np.isfinite(r.image()).all()


def test_nccl_needs_the_card():
    """No switch between backends: nccl with the CPU is refused."""
    with pytest.raises(ValueError, match="nccl"):
        sharding.local_device("nccl", "cpu")
    with pytest.raises(ValueError, match="backend"):
        sharding.init_distributed("mpi")


def test_sharded_adaptive_world1(world1):
    """The adaptive form: replans at the epoch boundaries, the counts sum
    to the path budget, and a renderer restored from the extras continues
    the stream bit for bit."""
    scene = W.sized("cornell", stratified=True, adaptive=True,
                    adaptive_epoch=2)
    r = sharding.ShardedRenderer(scene, device="cpu")
    r.render(5)
    assert r._next_replan == 6
    assert r.count.sum() == 5 * W.RES * W.RES
    img = r.image()
    assert img.shape == (W.RES, W.RES, 3) and np.isfinite(img).all()
    extras = r.checkpoint_extras()
    r2 = sharding.ShardedRenderer(W.sized("cornell", stratified=True,
                                          adaptive=True, adaptive_epoch=2),
                                  device="cpu")
    r2.restore_extras(extras)
    r2.load_accum(r.full_accum().numpy())
    r2.iteration = r.iteration
    r.step()
    r2.step()
    np.testing.assert_array_equal(r.full_accum().numpy(),
                                  r2.full_accum().numpy())
