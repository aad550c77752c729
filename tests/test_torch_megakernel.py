"""The torch port's megakernel module against the JAX package.

`iteration_plain` (the plain version of csrc/megakernel.cu) runs one
iteration on injected uniforms; the same uniforms drive the JAX wavefront
chain (intersect_planar -> shade_planar, the loop of render/integrator.
trace_wavefront) and the Pallas megakernel in interpret mode
(`run_interpret_with_uniforms`). The CUDA kernel itself needs a card:
tests/test_torch_cuda.py and chip_smoke.py hold it against
`iteration_plain`, and its two schedules against each other.

Contract (tests/test_megakernel.py): the programs are compiled separately,
so an ulp can flip a binary decision (nearest-hit ties, the frame pick at
SQRT_OF_ONE_THIRD, the Fresnel test, the thin-wall back-off) and a lane then
diverges wholesale. Lanes agree to 1e-4, at most 1% diverge, channel means
within 0.05. The glass scene keeps the looser 2e-4 / 2%: the Pallas kernel
starts transmitted rays from the backed-off point, the wavefront (and the
port) from the exact surface point.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.ops import megakernel as JMK
from project3_cuda_path_tracer_tpu.ops import wavefront as jwf
from project3_cuda_path_tracer_tpu.ops.vec import V3 as JV3
from project3_cuda_path_tracer_tpu_torch import load_scene
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
from project3_cuda_path_tracer_tpu_torch.render.integrator import \
    build_trace_config
from project3_cuda_path_tracer_tpu_torch.scene import types as PT
from project3_cuda_path_tracer_tpu_torch.scene.convert import scene_from_numpy
from project3_cuda_path_tracer_tpu_torch.utils.launches import launch_counts
from test_torch_cuda import assert_lane_contract

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "scenes")
CASES = {  # name: (resolution, depth, numpy seed, atol, divergent fraction)
    "cornell": (16, 3, 1, 1e-4, 0.01),
    "sphere": (16, 2, 2, 1e-4, 0.01),
    "cornell_glass": (16, 4, 3, 2e-4, 0.02),
}


def _sized(name, res):
    path = os.path.join(SCENES, name + ".txt")
    js, ps = jax_load_scene(path), load_scene(path)
    for s in (js, ps):
        s.camera.resolution = (res, res)
        s.camera.derive()
    return js, ps


def jax_wavefront_oracle(scene, res, depth, uniforms):
    """One iteration of the JAX planar chain on injected uniforms, AA off
    (the loop of tests/test_megakernel.py:26-48, written out again)."""
    n = res * res
    geom_types = tuple(int(t) for t in np.asarray(scene.geoms.type))

    def run(u):
        o, d, times, _ = jwf.generate_rays_planar(
            scene.camera.flat(), res, res, jax.random.PRNGKey(0),
            antialias=False, tile=0)
        thr = JV3(*(jnp.ones((n,), jnp.float32) for _ in range(3)))
        alive = jnp.ones((n,), bool)
        rad = JV3(*(jnp.zeros((n,), jnp.float32) for _ in range(3)))
        no = jnp.zeros((n,), bool)
        for b in range(depth):
            hit = jwf.intersect_planar(o, d, times, scene.geoms, scene.meshes,
                                       geom_types)
            out = jwf.shade_planar(hit, d, thr, alive, scene.materials,
                                   scene.textures, u[b], last_bounce=no,
                                   glossy=False, sky=False)
            rad = rad + out.radiance
            o, d, thr, alive = (out.origin, out.direction, out.throughput,
                                out.alive)
        return jnp.stack(list(rad))

    return np.asarray(run(jnp.asarray(uniforms)))


def port_plain(scene, depth, uniforms):
    """`iteration_plain` on the same uniforms -> [3, N] radiance planes."""
    cfg = dataclasses.replace(build_trace_config(scene), antialias=False,
                              trace_depth=depth)
    n = cfg.width * cfg.height
    acc = torch.zeros((cfg.height, cfg.width, 3))
    mk.iteration_plain(acc, mk.pack_scene(scene, "cpu"), cfg, 0, 0,
                       "uniforms", torch.zeros((mk.CAM_DIMS, n)),
                       torch.from_numpy(uniforms))
    return acc.reshape(n, 3).T.numpy()


def _uniforms(name):
    res, depth, seed, _, _ = CASES[name]
    rng = np.random.default_rng(seed)
    return rng.random((depth, 4, res * res), dtype=np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_wavefront(name):
    res, depth, _, atol, frac = CASES[name]
    js, ps = _sized(name, res)
    u = _uniforms(name)
    assert_lane_contract(port_plain(ps, depth, u),
                         jax_wavefront_oracle(js, res, depth, u), atol, frac)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret(name):
    res, depth, _, atol, frac = CASES[name]
    js, ps = _sized(name, res)
    u = _uniforms(name)
    want = np.stack(JMK.run_interpret_with_uniforms(js, res, res, depth, u))
    assert_lane_contract(port_plain(ps, depth, u), want, atol, frac)


def _from_jax(name):
    """A port scene built from the JAX package's tables (the parser of the
    port refuses meshes and textures)."""
    js = jax_load_scene(os.path.join(SCENES, name + ".txt"))
    mats = {k: np.asarray(getattr(js.materials, k)) for k in
            ("color", "specular_exponent", "specular_color",
             "has_reflective", "has_refractive", "ior", "emittance",
             "dispersion")}
    geoms = {k: np.asarray(getattr(js.geoms, k)) for k in
             ("type", "material_id", "transform", "inverse_transform",
              "inverse_transpose", "velocity", "mesh_id")}
    cam = {k: np.asarray(v) for k, v in js.camera.flat().items()}
    ps = scene_from_numpy(mats, geoms, cam, resolution=js.camera.resolution)
    tx = js.textures
    ps.textures = PT.Textures(**{k: torch.from_numpy(np.array(getattr(tx, k)))
                                 for k in ("atlas", "tex_id", "env",
                                           "env_enabled", "sky", "bump",
                                           "nrm_id")})
    return ps


def test_supports_accepts_cornell():
    assert mk.supports(load_scene(os.path.join(SCENES, "cornell.txt")))
    assert mk.supports(_from_jax("cornell_glass"))


@pytest.mark.parametrize("case,reason", [
    ("cornell_glossy", "SPECEX"), ("mesh", "mesh"),
    ("textured_env", "texture atlas"), ("sky", "sky"),
    ("constant_env", "constant environment"), ("checker", "checker")])
def test_supports_rejects(case, reason):
    """The JAX supports() accepts glossy, sky, constant-environment and
    checkered scenes and renders them without those terms; the port's
    refuses them, so they take the wavefront route. `mesh` is cornell with
    one geom turned into a mesh; `textured_env` is that scene's tables with
    its meshes turned into cubes, so that the textures alone decide;
    `checker` is cornell with a CHECKER on its white walls."""
    if case == "textured_env":
        scene = _from_jax(case)
        scene.geoms.type[scene.geoms.type == PT.MESH] = PT.CUBE
    elif case == "cornell_glossy":
        scene = _from_jax(case)
    else:
        scene = load_scene(os.path.join(SCENES, "cornell.txt"))
        if case == "mesh":
            scene.geoms.type[-1] = PT.MESH
        elif case == "sky":
            scene.textures.sky[0] = 1.0
        elif case == "checker":
            scene.textures.checker_scale[1] = 8.0
        else:
            scene.textures.env[0, 0] = torch.tensor([0.2, 0.3, 0.4])
            scene.textures.env_enabled = torch.tensor(1.0)
    assert not mk.supports(scene)
    with pytest.raises(NotImplementedError, match=reason):
        mk.require_supported(scene)


def _wrapper_inputs(res=12, depth=3):
    scene = load_scene(os.path.join(SCENES, "cornell.txt"))
    scene.camera.resolution = (res, res)
    scene.camera.derive()
    scene.settings.trace_depth = depth
    cfg = build_trace_config(scene)
    return cfg, mk.pack_scene(scene, "cpu"), torch.zeros((res, res, 3))


@pytest.mark.parametrize("sampler", ["philox", "stratified"])
def test_wrapper_takes_plain_path_on_cpu(sampler):
    cfg, table, acc = _wrapper_inputs()
    before = launch_counts()
    out = mk.iteration(acc, table, cfg, 2, 5, sampler)
    assert out is acc and launch_counts() == before
    want = mk.iteration_plain(torch.zeros_like(acc), table, cfg, 2, 5,
                              sampler)
    assert torch.equal(acc, want) and acc.sum() > 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "cam_u",
                                 "sampler", "table"])
def test_wrapper_rejects_bad_inputs(bad):
    cfg, table, acc = _wrapper_inputs()
    n = cfg.width * cfg.height
    args = dict(accum=acc, scene_table=table, cfg=cfg, iteration=0, seed=0,
                sampler="philox")
    if bad == "dtype":
        args["accum"] = acc.double()
    elif bad == "shape":
        args["accum"] = torch.zeros((cfg.height, cfg.width + 1, 3))
    elif bad == "contiguous":
        args["accum"] = torch.zeros((cfg.width, cfg.height, 3)).transpose(0, 1)
    elif bad == "cam_u":
        args.update(sampler="uniforms", cam_u=torch.zeros((2, n)),
                    u=torch.zeros((cfg.trace_depth, 4, n)))
    elif bad == "sampler":
        args["sampler"] = "sobol"
    else:
        args["scene_table"] = table[:-3]
    with pytest.raises((TypeError, ValueError)):
        mk.iteration(**args)


def test_grid_schedule_needs_cuda_tensors():
    """The grid schedule exists for the A/B on the card: CPU tensors raise
    rather than take the plain version, and nothing is counted."""
    cfg, table, acc = _wrapper_inputs()
    before = launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        mk._iteration_grid(acc, table, cfg, 0, 0, "philox")
    assert launch_counts() == before
