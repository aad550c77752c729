"""Checkpoint and resume in the torch port (render/checkpoint.py,
Renderer.checkpoint_extras/restore_extras, the CLI's --checkpoint-every and
--resume) against the JAX package's file format.

The `.ckpt.npz` keys are the JAX package's, so a file written by either
package loads in the other, extras included. A resumed render continues
the uninterrupted one's stream: the port draws from (seed, iteration), so
a uniform render (K1's plain version on the CPU, the wavefront route) and
a ReSTIR render (its reservoir in the extras) resume bit for bit, through
the Renderer and through the CLI.
"""
import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu.render import checkpoint as JC
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.app import cli
from project3_cuda_path_tracer_tpu_torch.render import checkpoint as PC

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
CORNELL = os.path.join(SCENES, "cornell.txt")


@pytest.fixture
def scene_file(tmp_path):
    p = tmp_path / "s.txt"
    p.write_text("MATERIAL 0\nRGB 1 1 1\n")
    return str(p)


def test_roundtrip(tmp_path, scene_file):
    acc = np.random.default_rng(0).random((4, 4, 3)).astype(np.float32)
    path = str(tmp_path / "c.ckpt.npz")
    PC.save_checkpoint(path, acc, 17, 42, scene_file,
                       extras={"count": np.full((4, 4), 3.0)})
    back, it, seed = PC.load_checkpoint(path, scene_file)
    np.testing.assert_array_equal(back, acc)
    assert it == 17 and seed == 42
    np.testing.assert_array_equal(PC.load_extras(path)["count"], 3.0)


def test_scene_hash_matches_jax_and_guards(tmp_path, scene_file):
    assert PC.scene_hash(scene_file) == JC.scene_hash(scene_file)
    other = tmp_path / "b.txt"
    other.write_text("MATERIAL 0\nRGB 0 0 1\n")
    path = str(tmp_path / "c.ckpt.npz")
    PC.save_checkpoint(path, np.zeros((2, 2, 3), np.float32), 1, 0,
                       scene_file)
    with pytest.raises(ValueError, match="different scene"):
        PC.load_checkpoint(path, str(other))


def test_find_checkpoint(tmp_path, scene_file):
    base = str(tmp_path / "img")
    assert PC.find_checkpoint(base) is None
    PC.save_checkpoint(base + ".ckpt.npz", np.zeros((1, 1, 3), np.float32),
                       0, 0, scene_file)
    assert PC.find_checkpoint(base) == JC.find_checkpoint(base) \
        == base + ".ckpt.npz"


def _extras(seed):
    rng = np.random.default_rng(seed)
    return dict(accum2=rng.random((3, 5)).astype(np.float32),
                count=np.full((3, 5), 2.0), plan_pix=np.arange(15),
                next_replan=np.int64(40))


@pytest.mark.parametrize("writer,reader", [(JC, PC), (PC, JC)])
def test_checkpoint_files_cross_load(tmp_path, scene_file, writer, reader):
    acc = np.random.default_rng(1).random((3, 5, 3)).astype(np.float32)
    path = str(tmp_path / "x.ckpt.npz")
    writer.save_checkpoint(path, acc, 9, 5, scene_file, extras=_extras(2))
    back, it, seed = reader.load_checkpoint(path, scene_file)
    np.testing.assert_array_equal(back, acc)
    assert (it, seed) == (9, 5)
    got = reader.load_extras(path)
    for k, v in _extras(2).items():
        np.testing.assert_array_equal(got[k], v)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            ["accum", "iteration", "seed", "scene_hash"]
            + ["x_" + k for k in _extras(2)])


def _resume(make, total, split, path):
    """(uninterrupted renderer, resumed renderer): `total` iterations, or
    `split` then a checkpoint file then the rest in a new renderer."""
    whole = make()
    whole.render(total)
    first = make()
    first.render(split)
    PC.save_checkpoint(path, first.accum.numpy(), first.iteration,
                       first.seed, CORNELL, extras=first.checkpoint_extras())
    second = make()
    accum, it, seed = PC.load_checkpoint(path, CORNELL)
    second.accum.copy_(torch.from_numpy(accum))
    second.iteration, second.seed = it, seed
    second.restore_extras(PC.load_extras(path))
    second.render(total - split)
    return whole, second


def _small(res=16, depth=3, **settings):
    s = load_scene(CORNELL)
    s.camera.resolution = (res, res)
    s.camera.derive()
    s.settings.trace_depth = depth
    for k, v in settings.items():
        setattr(s.settings, k, v)
    return s


@pytest.mark.parametrize("settings", [{}, {"russian_roulette": True},
                                      {"nee": True}])
def test_uniform_resume_is_bitwise(tmp_path, settings):
    """K1's plain version ({}), the wavefront route's generators (roulette,
    NEE's light generator): each iteration draws from (seed, iteration)."""
    whole, resumed = _resume(
        lambda: Renderer(_small(**settings), device="cpu"), 5, 3,
        str(tmp_path / "u.ckpt.npz"))
    assert resumed.iteration == 5 and resumed.checkpoint_extras() == {}
    assert torch.equal(whole.accum, resumed.accum)


def test_restir_resume_is_bitwise(tmp_path):
    whole, resumed = _resume(
        lambda: Renderer(_small(restir=4), device="cpu"), 5, 2,
        str(tmp_path / "r.ckpt.npz"))
    assert whole.cfg.restir
    assert set(whole.checkpoint_extras()) == {
        "res_" + k for k in whole.reservoir}
    assert torch.equal(whole.accum, resumed.accum)
    for k in whole.reservoir:
        assert torch.equal(whole.reservoir[k], resumed.reservoir[k]), k


def test_restir_restore_without_reservoir_raises():
    r = Renderer(_small(restir=4), device="cpu")
    with pytest.raises(ValueError, match="restir"):
        r.restore_extras({})


def test_jax_adaptive_checkpoint_resumes_in_port(tmp_path):
    """A checkpoint in the JAX package's adaptive layout (int32 plan, x_
    extras) restores into the port's adaptive Renderer, which continues
    from it."""
    r = Renderer(_small(8, 2, adaptive=True, adaptive_epoch=2,
                        stratified=True), device="cpu")
    r.render(3)
    ex = r.checkpoint_extras()
    ex["plan_pix"] = ex["plan_pix"].astype(np.int32)
    ex["plan_surr"] = ex["plan_surr"].astype(np.int32)
    path = str(tmp_path / "a.ckpt.npz")
    JC.save_checkpoint(path, r.accum.numpy(), 3, 0, CORNELL, extras=ex)
    q = Renderer(_small(8, 2, adaptive=True, adaptive_epoch=2,
                        stratified=True), device="cpu")
    accum, it, _ = PC.load_checkpoint(path, CORNELL)
    q.accum.copy_(torch.from_numpy(accum))
    q.iteration = it
    q.restore_extras(PC.load_extras(path))
    q.render(2)
    r.render(2)
    assert (q.count == r.count).all() and q.count.sum() == 5 * 64
    assert torch.equal(q.accum, r.accum)


def _cli(scene, outdir, out, iters, *flags):
    return cli.main([scene, "--device", "cpu", "--iterations", str(iters),
                     "--depth", "4", "--outdir", outdir, "--out", out,
                     *flags])


@pytest.mark.parametrize("flags", [(), ("--adaptive", "--adaptive-epoch",
                                        "3", "--stratified")])
def test_cli_resume_matches_uninterrupted(tmp_path, capsys, flags):
    """--checkpoint-every 4 to 4 iterations, then --resume to 12, against 12
    iterations in one run: the final checkpoints' accumulators are equal
    (adaptive, resumed mid-epoch: counts exactly, sums to 2e-5; its counts
    spread from the replan at 9, the first after 8 samples a pixel)."""
    with open(CORNELL) as f:
        text = f.read().replace("RES         800 800", "RES         24 24")
    scene = str(tmp_path / "c24.txt")
    with open(scene, "w") as f:
        f.write(text)
    out = str(tmp_path)
    assert _cli(scene, out, "split", 4, "--checkpoint-every", "4",
                *flags) == 0
    assert _cli(scene, out, "split", 12, "--checkpoint-every", "4",
                "--resume", *flags) == 0
    assert "resumed from" in capsys.readouterr().err
    assert _cli(scene, out, "whole", 12, "--checkpoint-every", "4",
                *flags) == 0
    a, it_a, _ = PC.load_checkpoint(os.path.join(out, "split.ckpt.npz"),
                                    scene)
    b, it_b, _ = PC.load_checkpoint(os.path.join(out, "whole.ckpt.npz"),
                                    scene)
    assert it_a == it_b == 12
    if not flags:
        np.testing.assert_array_equal(a, b)
        return
    xa = PC.load_extras(os.path.join(out, "split.ckpt.npz"))
    xb = PC.load_extras(os.path.join(out, "whole.ckpt.npz"))
    np.testing.assert_array_equal(xa["count"], xb["count"])
    assert xa["count"].sum() == 12 * 24 * 24 and xa["count"].std() > 0
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
