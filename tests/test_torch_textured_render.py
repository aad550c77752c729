"""Whole stratified iterations of the textured scenes (slice D): the port's
Renderer on the CPU against JAX `render_radiance`.

With `stratified=True` every draw of an iteration is a hash of (iteration,
depth, pixel), the same in both packages, so the port's trace must
reproduce JAX's lane by lane under the lane contract of
tests/test_torch_megakernel.py (lanes to 1e-4, at most 1% diverge, means
within 0.05). 32x32, depth 4: textured_env nearest, --bilinear and
--bilinear-fast; textured_env_proc (checker and sky); the bump and
normal-map scene of tests/test_torch_textures.py. The JAX trace runs the
torus's 8-wide traversal in Pallas interpret mode, as the JAX package's
own tests do on the CPU; the port's runs traverse8_plain and P1's plain
gather.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.render import integrator as JI
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.utils.launches import launch_counts
from test_torch_megakernel import assert_lane_contract
from test_torch_textures import bump_scene_path

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
RES, DEPTH = 32, 4


@pytest.fixture(scope="module")
def loaded():
    """name -> (JAX scene, port scene), each file parsed once."""
    out = {}
    for name in ("textured_env", "textured_env_proc"):
        path = os.path.join(SCENES, name + ".txt")
        out[name] = (jax_load_scene(path), load_scene(path))
    return out


def sized(scene, **settings):
    """A copy of `scene` at RES x RES, DEPTH, stratified, with `settings`
    (the copy's textures may gain pair planes without touching the
    original's)."""
    cam = dataclasses.replace(scene.camera, resolution=(RES, RES)).derive()
    st = dataclasses.replace(scene.settings, trace_depth=DEPTH,
                             stratified=True, **settings)
    return dataclasses.replace(scene, camera=cam, settings=st)


def both_images(js, ps):
    """(port image, JAX image) of iteration 0, as [3, N] planes."""
    cfg = JI.build_trace_config(js, js.settings)
    want = np.asarray(jax.jit(lambda it: JI.render_radiance(
        js.materials, js.camera.flat(), js.geoms, js.meshes, js.textures,
        jax.random.PRNGKey(0), cfg, packed_meshes=js.packed_meshes,
        iteration=it))(jnp.int32(0)))
    r = Renderer(ps, device="cpu")
    assert r.route == "wavefront"
    got = r.render(1).numpy()
    assert got.shape == (RES, RES, 3) and np.isfinite(got).all()
    return got.reshape(-1, 3).T, want.reshape(-1, 3).T


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bilinear_fast"])
def test_textured_env_iteration_matches_jax(mode, loaded):
    """textured_env (the atlas on the floor and the torus, the env map on
    every miss, the fused fetch) in each filtering mode."""
    flags = dict(bilinear=mode != "nearest",
                 bilinear_fast=mode == "bilinear_fast")
    js, ps = (sized(s, **flags) for s in loaded["textured_env"])
    before = launch_counts()
    got, want = both_images(js, ps)
    assert_lane_contract(got, want)
    assert launch_counts() == before and before["p1"] == 0  # CPU: plain
    if mode == "bilinear_fast":
        assert ps.textures.atlas_pair.shape[0] == 512 * 512
        assert ps.textures.env_pair.shape[0] == 512 * 256


def test_textured_env_proc_iteration_matches_jax(loaded):
    """textured_env_proc: the procedural checker and sky, no texel fetch."""
    js, ps = (sized(s) for s in loaded["textured_env_proc"])
    got, want = both_images(js, ps)
    assert_lane_contract(got, want)


def test_bump_and_normal_map_iteration_matches_jax(tmp_path):
    """The bump and normal-map scene (its tangents from the intersect
    stage, its texel from the atlas)."""
    path = bump_scene_path(tmp_path)
    js, ps = (sized(s) for s in (jax_load_scene(path), load_scene(path)))
    cfg = JI.build_trace_config(js, js.settings)
    assert cfg.bump and cfg.nmap
    got, want = both_images(js, ps)
    assert_lane_contract(got, want)
    assert float(got.mean()) > 0
