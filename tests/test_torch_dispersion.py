"""Spectral dispersion (slice E) of the torch port against the JAX package.

The `dispersion=` branch of `shade_planar` on the same hit records (JAX's
intersection of scenes/dispersion.txt's camera rays, carried across) and
the same injected uniforms, under the lane contract of
tests/test_torch_megakernel.py (lanes to 1e-4, at most 1% diverge, means
within 0.05); the branch at zero strength against the plain shader, bit
for bit; one stratified iteration of dispersion.txt against JAX
`render_radiance`, under the lane contract.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.ops import wavefront as JW
from project3_cuda_path_tracer_tpu.render import integrator as JI
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as PW
from project3_cuda_path_tracer_tpu_torch.ops.vec import V3
from test_torch_megakernel import assert_lane_contract

torch.set_num_threads(2)

PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes", "dispersion.txt")
RES = 32


@pytest.fixture(scope="module")
def scenes():
    js, ps = jax_load_scene(PATH), load_scene(PATH)
    for s in (js, ps):
        s.camera.resolution = (RES, RES)
        s.camera.derive()
        s.settings.trace_depth = 4
        s.settings.stratified = True
    return js, ps


def _t(a):
    return torch.from_numpy(np.array(a))


def _hits(js):
    """JAX's nearest hits of the camera rays (stratified, iteration 0), as
    JAX and as port records, and the ray directions of both."""
    o, d, t, _ = JW.generate_rays_planar(
        js.camera.flat(), RES, RES, jax.random.PRNGKey(0), stratified=True,
        iteration=0)
    types = tuple(int(g) for g in np.asarray(js.geoms.type))
    jh = JW.intersect_planar(o, d, t, js.geoms, js.meshes, types)
    ph = PW.HitP(t=_t(jh.t), normal=V3(*map(_t, jh.normal)),
                 mat_id=_t(jh.mat_id).long(), point=V3(*map(_t, jh.point)),
                 surf=V3(*map(_t, jh.surf)), u=_t(jh.u), v=_t(jh.v),
                 outside=_t(jh.outside))
    return jh, ph, d, V3(*map(_t, d))


def _shade_port(ps, ph, pd, u, dispersion):
    n = RES * RES
    one = torch.ones(n)
    return PW.shade_planar(
        ph, pd, V3(one, one, one), torch.ones(n, dtype=torch.bool),
        ps.materials, ps.textures, tuple(_t(c) for c in u),
        last_bounce=torch.zeros(n, dtype=torch.bool), glossy=False,
        dispersion=dispersion)


def _planes(out):
    return np.stack([np.asarray(c) for c in (*out.origin, *out.direction,
                                             *out.throughput,
                                             *out.radiance)])


def test_shade_dispersion_branch_matches_jax(scenes):
    js, ps = scenes
    jh, ph, jd, pd = _hits(js)
    u = np.random.default_rng(0).random((4, RES * RES), dtype=np.float32)
    n = RES * RES
    one = jnp.ones((n,), jnp.float32)
    want = JW.shade_planar(
        jh, jd, JW.V3(one, one, one), jnp.ones((n,), bool), js.materials,
        js.textures, tuple(jnp.asarray(c) for c in u),
        last_bounce=jnp.zeros((n,), bool), glossy=False, sky=False,
        dispersion=True)
    got = _shade_port(ps, ph, pd, u, dispersion=True)
    assert_lane_contract(_planes(got), _planes(want))
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    # the glass lanes carry 3x one band and none of the others
    glass = (ph.mat_id == 2) & (ph.t > 0)
    assert int(glass.sum()) > 10
    thr = torch.stack(list(got.throughput))[:, glass]
    assert bool(((thr > 0).sum(0) == 1).all())
    assert torch.equal(thr.max(0).values, torch.full_like(thr[0], 3 * 0.98))


def test_zero_dispersion_equals_plain_shader(scenes):
    js, ps = scenes
    _, ph, _, pd = _hits(js)
    u = np.random.default_rng(1).random((4, RES * RES), dtype=np.float32)
    flat = dataclasses.replace(ps, materials=dataclasses.replace(
        ps.materials, dispersion=torch.zeros_like(ps.materials.dispersion)))
    on = _shade_port(flat, ph, pd, u, dispersion=True)
    off = _shade_port(flat, ph, pd, u, dispersion=False)
    for a, b in zip(on, off):
        if a is None:
            assert b is None
            continue
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert torch.equal(x, y)


def test_dispersion_iteration_matches_jax(scenes):
    js, ps = scenes
    cfg = JI.build_trace_config(js, js.settings)
    assert cfg.dispersion
    want = np.asarray(jax.jit(lambda it: JI.render_radiance(
        js.materials, js.camera.flat(), js.geoms, js.meshes, js.textures,
        jax.random.PRNGKey(0), cfg, iteration=it))(jnp.int32(0)))
    r = Renderer(ps, device="cpu")
    assert r.route == "wavefront" and r.cfg.dispersion
    got = r.render(1).numpy()
    assert np.isfinite(got).all() and got.mean() > 0
    assert_lane_contract(got.reshape(-1, 3).T, want.reshape(-1, 3).T)
