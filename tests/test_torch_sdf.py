"""SDF primitives (slice E) of the torch port against the JAX package.

ops/sdf.py per kind (torus, roundbox, capsule, metaball, the three CSG
booleans) on seeded object-space points and rays; the parsed
scenes/sdf.txt and `scene_from_numpy`; `intersect_planar` with SDF geoms
for nearest and any hit; one stratified iteration of sdf.txt against JAX
`render_radiance`. Values are held to the lane contract of
tests/test_torch_megakernel.py (lanes to 1e-4, at most 1% diverge, means
within 0.05): the march is 64 data-dependent steps, and an ulp of torch's
sqrt chain against XLA's can move a lane's stopping step.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.ops import sdf as JS
from project3_cuda_path_tracer_tpu.ops import vec as JV
from project3_cuda_path_tracer_tpu.ops import wavefront as JW
from project3_cuda_path_tracer_tpu.render import integrator as JI
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.ops import sdf as PS
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as PW
from project3_cuda_path_tracer_tpu_torch.ops.vec import V3
from project3_cuda_path_tracer_tpu_torch.scene.convert import scene_from_numpy
from test_torch_megakernel import assert_lane_contract

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
SDF_SCENE = os.path.join(SCENES, "sdf.txt")
N = 2048


def _row(vals):
    row = np.zeros(PS.PARAM_SLOTS, np.float32)
    row[:len(vals)] = vals
    return row


CSG = _row([0, 0, 0, 0.38, 0.38, 0.38, 0, 0, 0, 0, 0.45, 0.3])
KINDS = {
    "torus": ((PS.TORUS, -1, -1), _row([0.32, 0.11])),
    "roundbox": ((PS.ROUNDBOX, -1, -1), _row([0.3, 0.2, 0.25, 0.05])),
    "capsule": ((PS.CAPSULE, -1, -1), _row([0.25, 0.12])),
    "metaball": ((PS.METABALL, 3, -1), _row(
        [0.18, -0.22, -0.1, 0, 0.21, 0.22, -0.08, 0.05, 0.19, 0, 0.24,
         -0.04, 0.17])),
    "csg_diff": ((PS.CSG_DIFF, PS.SUB_BOX, PS.SUB_SPHERE), CSG),
    "csg_inter": ((PS.CSG_INTER, PS.SUB_BOX, PS.SUB_SPHERE), CSG),
    "csg_union": ((PS.CSG_UNION, PS.SUB_SPHERE, PS.SUB_BOX), _row(
        [0.1, 0, 0, 0.25, 0, 0, 0, 0, -0.1, 0.05, 0, 0.2, 0.15, 0.2])),
}


def _rays(seed: int):
    """Object-space rays: 3/4 from a radius-1.5 sphere aimed near the
    origin, 1/4 from points within 0.1 of it (interior starts for the
    solid kinds); unit directions."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, N)).astype(np.float32)
    o /= np.linalg.norm(o, axis=0, keepdims=True)
    o *= 1.5
    o[:, 3 * N // 4:] = rng.uniform(-0.1, 0.1, (3, N // 4))
    d = rng.uniform(-0.3, 0.3, (3, N)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _pv(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def _jv(a):
    return JV.V3(*(jnp.asarray(c) for c in a))


@pytest.mark.parametrize("name", sorted(KINDS))
def test_sdf_eval_and_normal_match_jax(name):
    kind, row = KINDS[name]
    p = np.random.default_rng(1).uniform(-0.6, 0.6, (3, N)).astype(
        np.float32)
    got = PS.sdf_eval(_pv(p), kind, torch.from_numpy(row)).numpy()
    want = np.asarray(JS.sdf_eval(_jv(p), kind, jnp.asarray(row)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    gn = PS.normal_local(_pv(p), kind, torch.from_numpy(row))
    wn = JS.normal_local(_jv(p), kind, jnp.asarray(row))
    assert_lane_contract(np.stack([c.numpy() for c in gn]),
                         np.stack([np.asarray(c) for c in wn]))
    np.testing.assert_allclose(
        float(PS._bounding_radius(kind, torch.from_numpy(row))),
        float(JS._bounding_radius(kind, jnp.asarray(row))), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(KINDS))
def test_march_local_matches_jax(name):
    """t (1e9 on misses, so a hit/miss flip is a divergent lane), the hit
    mask and the start side, against the JAX march."""
    kind, row = KINDS[name]
    o, d = _rays(2)
    t, hit, outside = PS.march_local(_pv(o), _pv(d), kind,
                                     torch.from_numpy(row))
    march = jax.jit(lambda qo, qd, prm: JS.march_local(qo, qd, kind, prm))
    jt, jhit, jout = (np.asarray(a) for a in march(_jv(o), _jv(d),
                                                   jnp.asarray(row)))
    np.testing.assert_array_equal(outside.numpy(), jout)
    assert hit.numpy().mean() > 0.2 and (~outside.numpy()).any() == (
        name not in ("torus", "csg_inter"))
    g = np.where(hit.numpy(), t.numpy(), 1e9)[None]
    w = np.where(jhit, jt, 1e9)[None]
    assert_lane_contract(g, w, mean_tol=np.inf)


def _scenes(res=24):
    js, ps = jax_load_scene(SDF_SCENE), load_scene(SDF_SCENE)
    for s in (js, ps):
        s.camera.resolution = (res, res)
        s.camera.derive()
    return js, ps


def test_parsed_sdf_scene_matches_jax_and_converts():
    js, ps = jax_load_scene(SDF_SCENE), load_scene(SDF_SCENE)
    assert ps.sdf_kinds == js.sdf_kinds
    assert ps.sdf_kinds[6:] == ((PS.TORUS, -1, -1), (PS.METABALL, 3, -1),
                                (PS.CSG_DIFF, PS.SUB_BOX, PS.SUB_SPHERE))
    np.testing.assert_array_equal(ps.geoms.sdf_params.numpy(),
                                  np.asarray(js.geoms.sdf_params))
    assert ps.geoms.sdf_params.dtype == torch.float32
    geoms = {k: np.asarray(getattr(js.geoms, k)) for k in (
        "type", "material_id", "transform", "inverse_transform",
        "inverse_transpose", "velocity", "mesh_id", "sdf_params")}
    mats = {k: np.asarray(getattr(js.materials, k)) for k in (
        "color", "specular_exponent", "specular_color", "has_reflective",
        "has_refractive", "ior", "emittance")}
    conv = scene_from_numpy(mats, geoms,
                            {k: np.asarray(v)
                             for k, v in js.camera.flat().items()},
                            resolution=js.camera.resolution,
                            sdf_kinds=js.sdf_kinds)
    assert conv.sdf_kinds == ps.sdf_kinds
    assert torch.equal(conv.geoms.sdf_params, ps.geoms.sdf_params)
    assert load_scene(os.path.join(SCENES, "cornell.txt")).sdf_kinds == ()


@pytest.mark.parametrize("any_hit", [False, True])
def test_intersect_planar_with_sdfs_matches_jax(any_hit):
    """sdf.txt's 24x24 camera rays (stratified, iteration 0) through every
    geom, three of them SDFs: nearest hits (t, normal, material) or, as a
    shadow query bounded at 11 world units, the occlusion bit."""
    js, ps = _scenes()
    jo, jd, jt, _ = JW.generate_rays_planar(
        js.camera.flat(), 24, 24, jax.random.PRNGKey(0), stratified=True,
        iteration=0)
    po, pd, pt, _ = PW.generate_rays_planar(ps.camera.flat(), 24, 24,
                                            stratified=True, iteration=0)
    types = tuple(int(t) for t in np.asarray(js.geoms.type))
    max_t = 11.0 if any_hit else None
    want = JW.intersect_planar(
        jo, jd, jt, js.geoms, js.meshes, types, sdf_kinds=js.sdf_kinds,
        any_hit=any_hit,
        max_t=None if max_t is None else jnp.full((576,), max_t))
    got = PW.intersect_planar(
        po, pd, pt, ps.geoms, types, sdf_kinds=ps.sdf_kinds,
        any_hit=any_hit,
        max_t=None if max_t is None else torch.full((576,), max_t))
    if any_hit:
        agree = (got.t.numpy() > 0) == (np.asarray(want.t) > 0)
        assert agree.mean() >= 0.99 and (got.t.numpy() > 0).mean() > 0.3
        return
    assert (np.asarray(want.mat_id) >= 4).sum() > 20  # the SDFs are hit
    assert_lane_contract(
        np.stack([got.t.numpy(), *(c.numpy() for c in got.normal),
                  got.mat_id.numpy().astype(np.float32)]),
        np.stack([np.asarray(want.t), *(np.asarray(c) for c in want.normal),
                  np.asarray(want.mat_id).astype(np.float32)]))


def test_sdf_iteration_matches_jax():
    """One stratified iteration of sdf.txt at 32x32 depth 4 (the torus's
    glossy lobe, the metaball, the mirror CSG cube): the port's Renderer
    on the CPU against JAX render_radiance."""
    js, ps = _scenes(32)
    js.settings.trace_depth = ps.settings.trace_depth = 4
    js.settings.stratified = ps.settings.stratified = True
    cfg = JI.build_trace_config(js, js.settings)
    want = np.asarray(jax.jit(lambda it: JI.render_radiance(
        js.materials, js.camera.flat(), js.geoms, js.meshes, js.textures,
        jax.random.PRNGKey(0), cfg, iteration=it))(jnp.int32(0)))
    r = Renderer(ps, device="cpu")
    assert r.route == "wavefront" and r.cfg.sdf_kinds == js.sdf_kinds
    got = r.render(1).numpy()
    assert np.isfinite(got).all() and got.mean() > 0
    assert_lane_contract(got.reshape(-1, 3).T, want.reshape(-1, 3).T)


def test_sdf_hit_flips_the_normal_inside():
    """A ray that starts inside the metaball leaves through its surface:
    the hit is reported from inside (outside False) and the normal faces
    the ray."""
    _, ps = _scenes()
    g = 7
    o = V3(*(torch.full((4,), float(v)) for v in
             ps.geoms.transform[g][:3, 3]))
    d = PW.vec.normalize(V3(torch.tensor([1.0, -1, 0, 0]),
                            torch.tensor([0.0, 0, 1, -1]),
                            torch.tensor([0.0, 0, 0, 1])))
    hit = PW._sdf_hit_planar(o, d, torch.zeros(4), ps.geoms, g,
                             ps.sdf_kinds[g])
    assert (hit.t < PW.BIG).all() and not hit.outside.any()
    assert (PW.vec.dot(hit.normal, d) < 0).all()
    moved = dataclasses.replace(ps.geoms, sdf_params=None)
    with pytest.raises(ValueError, match="SDF geom"):
        PW.intersect_planar(o, d, torch.zeros(4), moved,
                            tuple(int(t) for t in ps.geoms.type),
                            sdf_kinds=ps.sdf_kinds)
