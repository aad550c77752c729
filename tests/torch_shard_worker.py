"""One rank of the 2-process gloo runs of tests/test_torch_sharding.py (not
a test file: the tests start it with subprocess).

    python tests/torch_shard_worker.py INIT_FILE RANK WORLD OUT.npz

Joins the group through a file:// store at INIT_FILE, then renders each
case of `cases()` with the ShardedRenderer and takes the sharded history
train step's loss and gradients; rank 0 writes the gathered results to
OUT.npz. Imports torch and the port only.
"""
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from project3_cuda_path_tracer_tpu_torch import load_scene  # noqa: E402
from project3_cuda_path_tracer_tpu_torch.models import inverse as inv  # noqa
from project3_cuda_path_tracer_tpu_torch.parallel import sharding  # noqa

SCENES = os.path.join(REPO, "scenes")
RES, DEPTH, ITERS = 16, 3, 3


def sized(name, res=RES, **settings):
    s = load_scene(os.path.join(SCENES, name + ".txt"))
    s.camera.resolution = (res, res)
    s.camera.derive()
    s.settings.trace_depth = DEPTH
    for k, v in settings.items():
        setattr(s.settings, k, v)
    return s


def cases():
    """name -> a function returning a fresh scene (the tests' own list)."""
    return {
        "cornell_philox": lambda: sized("cornell"),
        "cornell_stratified": lambda: sized("cornell", stratified=True),
        "cornell_nee_rr": lambda: sized("cornell", nee=True,
                                        russian_roulette=True),
        "mesh": lambda: sized("textured_env_proc", res=8),
    }


def train_inputs(scene):
    """(target, residual) of the train-step check, from a numpy seed."""
    w, h = scene.camera.resolution
    rng = np.random.default_rng(6)
    return (torch.from_numpy(rng.random((h, w, 3), dtype=np.float32) * 0.3),
            torch.from_numpy(rng.random((h, w, 3), dtype=np.float32)))


def sharded_train(scene, seed=4):
    """(loss, gradients by leaf) of one sharded history step's loss on
    this rank's rows, summed over the ranks."""
    cfg, _ = sharding.make_train_step_sharded(scene, "cpu")
    tables, packed, meshes = sharding.shard_scene(scene, "cpu")
    lo, hi = sharding.row_block(scene.camera.resolution[1],
                                sharding.dist.get_world_size(),
                                sharding.dist.get_rank())
    target, resid = train_inputs(scene)
    params = inv.params_from_scene(scene, "cpu")
    loss, _ = sharding.history_loss_sharded(
        params, tables, cfg, target[lo:hi], resid[lo:hi], packed, meshes,
        inv.step_generator(seed, 0, "cpu"))
    total, grads = sharding.all_reduce_grads(loss, inv.param_leaves(params))
    return total, grads


def main(init_file, rank, world, out):
    torch.set_num_threads(1)
    sharding.init_distributed("gloo", f"file://{init_file}", int(world),
                              int(rank))
    res = {}
    try:
        for name, make in cases().items():
            r = sharding.ShardedRenderer(make(), device="cpu")
            r.render(ITERS, seed=5)
            res["img_" + name] = r.image()
        loss, grads = sharded_train(sized("cornell"))
        res["train_loss"] = loss.numpy()
        for i, g in enumerate(grads):
            if g is not None:
                res[f"train_grad_{i}"] = g.numpy()
    finally:
        sharding.shutdown()
    if int(rank) == 0:
        np.savez(out, **res)


if __name__ == "__main__":
    main(*sys.argv[1:5])
