"""Render diagnostics in the torch port (render/diagnostics.py) against the
JAX package: the live-path histogram and the compaction ratios.

The port draws its bounces from a torch generator and the JAX module from
jax.random, so the histograms agree in distribution: index 0 (every path)
exactly, the live fractions at 128x128 within 0.02 (a fraction's standard
error there is below 0.004).
"""
import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.render import diagnostics as JD
from project3_cuda_path_tracer_tpu_torch import load_scene
from project3_cuda_path_tracer_tpu_torch.render import diagnostics as PD

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")


def _sized(load, name, res, depth):
    s = load(os.path.join(SCENES, name + ".txt"))
    s.camera.resolution = (res, res)
    s.camera.derive()
    s.settings.trace_depth = depth
    return s


@pytest.mark.parametrize("name", ["cornell", "cornell_glass"])
def test_live_path_histogram_matches_jax(name):
    res, depth = 128, 4
    got = PD.live_path_histogram(_sized(load_scene, name, res, depth),
                                 seed=1, device="cpu")
    want = JD.live_path_histogram(_sized(jax_load_scene, name, res, depth),
                                  seed=1)
    assert got.shape == (depth + 1,) and got[0] == want[0] == res * res
    assert (np.diff(got) <= 0).all()
    np.testing.assert_allclose(got / got[0], want / want[0], atol=0.02)
    # cornell: most paths survive bounce 1 (walls), some die on the light
    assert got[1] > 0.5 * got[0]


def test_compaction_ratios_bounded():
    """The JAX tests/test_diagnostics.py claims on scenes/sphere.txt: every
    path hits the light or misses on bounce 0."""
    r = PD.compaction_ratios(_sized(load_scene, "sphere", 16, 3),
                             device="cpu")
    assert r[0] == 1.0 and (r >= 0).all() and (r <= 1).all()
    assert r[1] == 0.0


def test_histogram_depends_on_seed_only():
    s = _sized(load_scene, "cornell", 32, 3)
    a, b = (PD.live_path_histogram(s, seed=4, device="cpu")
            for _ in range(2))
    np.testing.assert_array_equal(a, b)
