"""Scene layer of the torch port against the JAX package's.

The port's parser (project3_cuda_path_tracer_tpu_torch/scene/parser.py) must
produce the JAX parser's tables from the same file, and `scene_from_numpy`
must carry the JAX tables over unchanged.
"""
import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu_torch import load_scene
from project3_cuda_path_tracer_tpu_torch.scene import types as PT
from project3_cuda_path_tracer_tpu_torch.scene.convert import scene_from_numpy

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "scenes")
PRIMITIVE = ["cornell", "cornell_dof", "cornell_glass", "cornell_glossy",
             "sphere", "lights", "manylights"]
MAT_FIELDS = ["color", "specular_exponent", "specular_color",
              "has_reflective", "has_refractive", "ior", "emittance",
              "dispersion"]
GEOM_FLOAT = ["transform", "inverse_transform", "inverse_transpose",
              "velocity"]
GEOM_INT = ["type", "material_id", "mesh_id"]
CAM_KEYS = ["position", "view", "up", "right", "pixel_length", "aperture",
            "focal_distance", "shutter"]


def _path(name):
    return os.path.join(SCENES, name + ".txt")


def _jax_tables(js):
    mats = {k: np.asarray(getattr(js.materials, k)) for k in MAT_FIELDS}
    geoms = {k: np.asarray(getattr(js.geoms, k))
             for k in GEOM_FLOAT + GEOM_INT}
    cam = {k: np.asarray(v) for k, v in js.camera.flat().items()}
    return mats, geoms, cam


def _assert_scene_matches(port, js):
    mats, geoms, cam = _jax_tables(js)
    for k in MAT_FIELDS:
        np.testing.assert_allclose(getattr(port.materials, k).numpy(),
                                   mats[k], atol=1e-6, err_msg=k)
    for k in GEOM_FLOAT:
        got = getattr(port.geoms, k).numpy()
        assert got.shape == geoms[k].shape, k
        np.testing.assert_allclose(got, geoms[k], atol=1e-6, err_msg=k)
    for k in GEOM_INT:
        np.testing.assert_array_equal(getattr(port.geoms, k).numpy(),
                                      geoms[k], err_msg=k)
    flat = port.camera.flat()
    for k in CAM_KEYS:
        np.testing.assert_allclose(flat[k].numpy(), cam[k], atol=1e-6,
                                   err_msg=k)
    assert tuple(port.camera.resolution) == tuple(js.camera.resolution)


@pytest.mark.parametrize("name", PRIMITIVE)
def test_parser_matches_jax(name):
    port = load_scene(_path(name))
    js = jax_load_scene(_path(name))
    _assert_scene_matches(port, js)
    for k in ("iterations", "trace_depth", "image_name", "antialias"):
        assert getattr(port.settings, k) == getattr(js.settings, k), k


@pytest.mark.parametrize("name", PRIMITIVE)
def test_scene_from_numpy_matches_parser(name):
    js = jax_load_scene(_path(name))
    mats, geoms, cam = _jax_tables(js)
    conv = scene_from_numpy(mats, geoms, cam, PT.RenderSettings(),
                            resolution=js.camera.resolution)
    _assert_scene_matches(conv, js)
    port = load_scene(_path(name))
    for k in MAT_FIELDS:
        assert torch.equal(getattr(conv.materials, k),
                           getattr(port.materials, k)), k
    for k in GEOM_FLOAT + GEOM_INT:
        assert torch.equal(getattr(conv.geoms, k), getattr(port.geoms, k)), k
    np.testing.assert_allclose(conv.camera.fovy, port.camera.fovy, rtol=1e-5)


@pytest.mark.parametrize("name,slice_name", [
    ("textured_env_proc", "slice D"), ("sdf", "slice E"),
    ("textured_env", "slice D")])
def test_unported_scenes_raise(name, slice_name):
    """The scenes of the slices that once raised here load with the JAX
    parser's tables: slice D's textured scenes (tests/test_torch_textures.py
    holds every Textures field) and slice E's sdf.txt, its SDF kinds and
    parameters too (tests/test_torch_sdf.py renders it)."""
    port, js = load_scene(_path(name)), jax_load_scene(_path(name))
    _assert_scene_matches(port, js)
    assert port.sdf_kinds == tuple(js.sdf_kinds)
    if slice_name == "slice E":
        assert len(port.sdf_kinds) == port.num_geoms
        np.testing.assert_array_equal(port.geoms.sdf_params.numpy(),
                                      np.asarray(js.geoms.sdf_params))
