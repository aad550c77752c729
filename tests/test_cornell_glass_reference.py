"""The cornell_glass deployment on the port's normal path against the plain
reference portbench/reference/texenv.py, on the CPU.

`load_scene` -> `Renderer` (the megakernel route, whose CPU form is
`ops/megakernel.iteration_plain`) -> `step_many` -> `image()` of the
configuration at 32x32, depth 8, its colours scaled by a seed as the
benchmark's runs scale them, over 8 stratified iterations, equals the
reference's retrace of every pixel to 2e-6: the port sums the
iterations in its float32 accumulator and the reference in float64, so a
pixel's mean differs by a few ulps (3e-7 at most here); a lane that took
another branch on a threshold would differ by ~1e-2. The glass sphere's
refractive lobe is taken, and so are the mirror and the light. cornell,
the other K1 configuration, is held alike.

    JAX_PLATFORMS=cpu python -m pytest tests/test_cornell_glass_reference.py
"""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "portbench")
sys.path[:0] = [p for p in (os.path.join(BENCH, "tests"), BENCH)
                if p not in sys.path]

import pb_small  # noqa: E402
from harness import inputs, roofline_k1, spec  # noqa: E402
from reference import texenv as TX  # noqa: E402
from reference import tracer as R  # noqa: E402

RES, DEPTH, ITERS = 32, 8, 8
ATOL = 2e-6
CELLS = {"cornell_glass": "cornell-glass-still", "cornell": "cornell-render"}


@pytest.mark.parametrize("config", sorted(CELLS))
def test_renderer_matches_the_reference(config):
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    c = pb_small.cell(CELLS[config], (RES, RES), DEPTH)
    assert c.config["name"] == config
    # written under a name of its own: other files write the cuts at once
    path = inputs.write_scene(dict(c.config, name=config + "_glass_ref"),
                              2 ** 31 + 17)
    scene = load_scene(path)
    scene.settings.stratified = True
    r = Renderer(scene, device="cpu")
    assert r.route == "megakernel" and r.sampler == "stratified"
    r.step_many(ITERS)
    img = r.image()[:, ::-1, :]        # image() is mirrored in x
    ts = TX.load(path)
    tab = TX.Tables(ts, "cpu")
    pix = torch.arange(RES * RES)
    ref = TX.retrace(tab, pix, ITERS, DEPTH).reshape(RES, RES, 3)
    assert np.abs(ref).sum() > 0
    np.testing.assert_allclose(img, ref, rtol=0, atol=ATOL)
    # the paths take every lobe the scene has
    counts = roofline_k1.segment_counts(tab, pix, 0, DEPTH)
    assert sum(counts["diffuse"]) > 0 and sum(counts["mirror"]) > 0
    glass = sum(counts["glass"]) + sum(counts["transmit"])
    assert (glass > 0) is (config == "cornell_glass")


def test_the_configuration_is_the_scene_file():
    """portbench/configs/cornell_glass.json holds scenes/cornell_glass.txt
    as it is, at its published size, with no cut."""
    cfg = spec.load_cell("cornell-glass-still").config
    with open(os.path.join(REPO, "scenes", "cornell_glass.txt")) as f:
        assert cfg["scene"] == f.read().rstrip("\n").split("\n")
    assert cfg["reduced"] == [] and cfg["published"]["RES"] == [800, 800]
    assert cfg["published"]["ITERATIONS"] == 5000
    sc = TX.load(inputs.write_scene(
        dict(cfg, name="cornell_glass_ref_config"), 5)).scene
    assert (sc.width, sc.height, sc.depth) == (800, 800, 8)
    refr = np.asarray(sc.materials["has_refractive"])
    assert refr.max() == 1 and float(np.asarray(sc.materials["ior"])[
        refr.argmax()]) == pytest.approx(1.52)


def test_camera_rays_are_the_reference_tracers():
    """The glass reference's camera is reference/tracer.py's: with no
    aperture the thin lens leaves the pinhole rays as they are."""
    cfg = spec.load_cell("cornell-glass-still").config
    ts = TX.load(inputs.write_scene(
        dict(cfg, name="cornell_glass_ref_camera"), 7))
    tab = TX.Tables(ts, "cpu")
    pix = torch.arange(0, 800 * 800, 997)
    draws = R.LatticeDraws(torch.full_like(pix, 3), pix)
    a = R.camera_rays(tab, pix, draws, dof=True)
    b = R.camera_rays(tab, pix, draws, dof=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
