"""Adaptive sampling in the torch port (render/adaptive.py) against the JAX
package.

The host planner (`apportion`, `plan_epoch`, `plan_from_err` at tile 0 and
32 with and without a cost, `identity_plan`, `cost_proxy_image` on
scenes/mesh.txt) is numpy in both packages and must agree bit for bit.
`error_image` to 1e-6 (the port's in float64, JAX's in float32).
One adaptive iteration under a fixed, non-uniform plan (stratified, so
every draw is a hash of (iteration, depth, surrogate) in both packages) is
held against JAX `render_radiance_adaptive` under the lane contract of
tests/test_torch_megakernel.py, on cornell and mesh.txt (the JAX side with
tile=0, the port's row-major order). The warm-up epoch equals the uniform
wavefront render bit for bit; a resumed adaptive render equals the
uninterrupted one, counts exactly, sums to 2e-5 (the JAX
tests/test_adaptive.py contract).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.ops import wavefront as JWF
from project3_cuda_path_tracer_tpu.render import adaptive as JA
from project3_cuda_path_tracer_tpu.render import integrator as JI
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as PWF
from project3_cuda_path_tracer_tpu_torch.render import adaptive as PA
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from test_torch_megakernel import assert_lane_contract
from test_torch_mesh import _port_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
CORNELL = os.path.join(SCENES, "cornell.txt")


def _sized(scene, w, h, depth=None, **settings):
    scene.camera.resolution = (w, h)
    scene.camera.derive()
    if depth is not None:
        scene.settings.trace_depth = depth
    for k, v in settings.items():
        setattr(scene.settings, k, v)
    return scene


@pytest.fixture(scope="module")
def blob():
    """(JAX scene, port scene) of scenes/mesh.txt, one SAH build."""
    js = jax_load_scene(os.path.join(SCENES, "mesh.txt"))
    return js, _port_scene(js)


def _sums(seed, h, w, spp=4.0):
    """Running sums of a plausible render: accum [h,w,3], accum2 [h,w],
    count [h,w], one pixel of large variance."""
    rng = np.random.default_rng(seed)
    count = np.full((h, w), spp)
    accum = rng.uniform(0.05, 1.0, (h, w, 3)) * count[..., None]
    lum = accum @ np.array([0.2126, 0.7152, 0.0722])
    accum2 = (lum / count) ** 2 * count * rng.uniform(1.0, 1.5, (h, w))
    accum2[h // 3, w // 2] += 50.0
    return (accum.astype(np.float32), accum2.astype(np.float32),
            count.astype(np.float32))


# ------------------------------------------------------------ the planner

@pytest.mark.parametrize("weights,total", [
    ([1.0, 3.0, 0.0, 4.0], 800), (np.zeros(7), 21),
    (np.random.default_rng(3).gamma(0.5, 1.0, 4096), 4096)])
def test_apportion_matches_jax(weights, total):
    got = PA.apportion(np.asarray(weights), total)
    assert got.sum() == total
    np.testing.assert_array_equal(got, JA.apportion(np.asarray(weights),
                                                    total))


def test_plan_epoch_matches_jax():
    accum, accum2, count = _sums(0, 16, 24)
    got, want = PA.plan_epoch(accum, accum2, count), JA.plan_epoch(
        accum, accum2, count)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    pix, surr, cimg = (np.asarray(a) for a in got)
    assert (np.bincount(pix, minlength=16 * 24).reshape(16, 24)
            == cimg.astype(np.int64)).all()
    assert len(np.unique(surr)) == len(surr) and cimg[5, 12] > 1


@pytest.mark.parametrize("tile", [0, 32])
@pytest.mark.parametrize("with_cost", [False, True])
def test_plan_from_err_matches_jax(tile, with_cost):
    rng = np.random.default_rng(7)
    h, w = 64, 96
    err = rng.gamma(0.7, 1.0, (h, w)).astype(np.float32)
    cost = None
    if with_cost:
        cost = np.where(rng.random((h, w)) < 0.3, 128.0, 1.0).astype(
            np.float32)
    got = PA.plan_from_err(err, tile=tile, cost=cost)
    want = JA.plan_from_err(err, tile=tile, cost=cost)
    assert got[0].dtype == torch.int64
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(wnt))


@pytest.mark.parametrize("w,h,tile", [(64, 32, 32), (24, 16, 0),
                                      (48, 40, 32)])
def test_identity_plan_matches_jax(w, h, tile):
    got, want = PA.identity_plan(w, h, tile), JA.identity_plan(w, h, tile)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(wnt))


def test_cost_proxy_image_matches_jax(blob):
    js, ps = blob
    for s in (js, ps):
        _sized(s, 96, 64)
    got = PA.cost_proxy_image(ps, 96, 64)
    want = JA.cost_proxy_image(js, 96, 64)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (64, 96) and 0 < (got > 1).mean() < 1
    # the 8-wide root row: empty child slots read as non-finite
    row = ps.packed_meshes[0].nodes[0, 0:48].numpy().reshape(8, 6)
    assert (np.isfinite(row).all(axis=1)
            == np.isfinite(row[:, 0])).all()


def test_cost_proxy_is_ones_without_meshes():
    s = _sized(load_scene(CORNELL), 16, 8)
    assert (PA.cost_proxy_image(s, 16, 8) == 1.0).all()


def test_error_image_matches_jax():
    accum, accum2, count = _sums(1, 32, 32)
    count[0, :4] = 0.0  # unsampled pixels clamp their count to 1
    got = PA.error_image(*(torch.from_numpy(a) for a in
                           (accum, accum2, count))).numpy()
    want = np.asarray(JA.error_image(*(jnp.asarray(a) for a in
                                       (accum, accum2, count))))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("base", [0, 2 ** 31 - 1 - 4096])
def test_surrogate_keys_match_jax_near_int32_max(base):
    """The port's draws take int64 keys and emulate uint32; the surrogates
    pix + occurrence * npix reach 2^31 - 1."""
    keys = np.arange(base, min(base + 4096, 2 ** 31), dtype=np.int64)
    for impl in ("lattice", "sobol"):
        got = PWF.stratified_planes(5, 2, torch.from_numpy(keys), 4,
                                    PWF.SALT_BOUNCE, impl=impl)
        want = JWF.stratified_planes(jnp.int32(5), 2,
                                     jnp.asarray(keys, jnp.int32), 4,
                                     PWF.SALT_BOUNCE, impl=impl)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_override_camera_rays_match_jax_near_int32_max():
    """generate_rays_planar under a pixel override, its stratified camera
    draws (AA, lens, shutter: cornell_dof) keyed on surrogates up to
    2^31 - 1, against the JAX function."""
    w = h = 16
    js = _sized(jax_load_scene(os.path.join(SCENES, "cornell_dof.txt")),
                w, h)
    ps = _sized(load_scene(os.path.join(SCENES, "cornell_dof.txt")), w, h)
    pix = np.random.default_rng(4).integers(0, w * h, w * h)
    surr = 2 ** 31 - 1 - np.arange(w * h)[::-1]
    got = PWF.generate_rays_planar(
        ps.camera.flat(), w, h, stratified=True, iteration=6,
        pixel_override=torch.from_numpy(pix),
        strat_index=torch.from_numpy(surr))
    want = JWF.generate_rays_planar(
        js.camera.flat(), w, h, jax.random.PRNGKey(0), stratified=True,
        iteration=jnp.int32(6), pixel_override=jnp.asarray(pix, jnp.int32),
        strat_index=jnp.asarray(surr, jnp.int32))
    np.testing.assert_array_equal(got[3].numpy(), pix)
    np.testing.assert_array_equal(np.asarray(want[3]), pix)
    for g, wnt in zip((*got[0], *got[1], got[2]),
                      (*want[0], *want[1], want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-6)


# ------------------------------------------------------------- rendering

def _fixed_plan(w, h, seed):
    rng = np.random.default_rng(seed)
    return PA.plan_from_err(rng.gamma(0.5, 1.0, (h, w)))


def _jax_adaptive(js, plan, iteration):
    cfg = dataclasses.replace(
        JI.build_trace_config(js, js.settings, adaptive=True), tile=0)
    pix, surr, _ = plan
    run = jax.jit(lambda it, p, s: JA.render_radiance_adaptive(
        js.materials, js.camera.flat(), js.geoms, js.meshes, js.textures,
        jax.random.PRNGKey(0), cfg, packed_meshes=js.packed_meshes,
        iteration=it, pix_override=p, samp_index=s))
    img, lum2 = run(jnp.int32(iteration), jnp.asarray(pix.numpy(), jnp.int32),
                    jnp.asarray(surr.numpy(), jnp.int32))
    return np.asarray(img), np.asarray(lum2)


def _port_adaptive(ps, plan, iteration):
    cfg = PI.build_trace_config(ps, ps.settings)
    assert cfg.adaptive and cfg.stratified
    pix, surr, _ = plan
    img, lum2 = PA.render_radiance_adaptive(
        ps.materials, ps.camera.flat(), ps.geoms, ps.textures, cfg,
        iteration=iteration, packed_meshes=ps.packed_meshes,
        pix_override=pix, samp_index=surr)
    return img.numpy(), lum2.numpy()


def _assert_images(got, want, n):
    img_g, l2_g = got
    img_w, l2_w = want
    assert np.isfinite(img_g).all() and np.isfinite(l2_g).all()
    assert_lane_contract(img_g.reshape(n, 3).T, img_w.reshape(n, 3).T)
    assert_lane_contract(l2_g.reshape(1, n), l2_w.reshape(1, n))


def test_adaptive_iteration_matches_jax_cornell():
    w = h = 32
    js = _sized(jax_load_scene(CORNELL), w, h, 4, stratified=True)
    ps = _sized(load_scene(CORNELL), w, h, 4, stratified=True,
                adaptive=True)
    plan = _fixed_plan(w, h, 11)
    assert plan[2].max() > 1  # several paths share pixels
    _assert_images(_port_adaptive(ps, plan, 3), _jax_adaptive(js, plan, 3),
                   w * h)


def test_adaptive_iteration_matches_jax_mesh(blob):
    js, ps = blob
    w = h = 32
    _sized(js, w, h, 3, stratified=True)
    _sized(ps, w, h, 3, stratified=True, adaptive=True)
    plan = _fixed_plan(w, h, 12)
    _assert_images(_port_adaptive(ps, plan, 1), _jax_adaptive(js, plan, 1),
                   w * h)


@pytest.mark.parametrize("stratified", [True, False])
def test_warmup_epoch_equals_uniform_wavefront(stratified):
    """The identity-mapped first epoch accumulates the uniform wavefront
    render bit for bit (render_radiance with the Renderer's draws: the
    Renderer itself would take K1 on cornell)."""
    s = _sized(load_scene(CORNELL), 24, 24, 3, stratified=stratified,
               adaptive=True, adaptive_epoch=8)
    r = Renderer(s, device="cpu")
    assert r.route == "wavefront" and r.cfg.adaptive
    r.render(3)
    cfg = dataclasses.replace(r.cfg, adaptive=False)
    want = torch.zeros_like(r.accum)
    for it in range(3):
        r.iteration = it
        want.add_(PI.render_radiance(
            *r.tables, cfg,
            generator=None if stratified else r._generator(), iteration=it))
    assert torch.equal(r.accum, want)
    assert (r.count == 3.0).all()
    r.iteration = 3
    np.testing.assert_array_equal(r.image(), want.numpy()[:, ::-1] / 3)


def _adaptive_cornell(**kw):
    s = _sized(load_scene(CORNELL), 24, 24, 3, stratified=True,
               adaptive=True, adaptive_epoch=4, **kw)
    return Renderer(s, device="cpu")


def test_adaptive_reallocates_budget():
    r = _adaptive_cornell()
    r.render(10)
    cnt = r.count
    assert cnt.sum() == 10 * 24 * 24 and cnt.std() > 0.0
    assert r.iteration == 10 and np.isfinite(r.image()).all()


def test_adaptive_resume_matches_uninterrupted():
    """checkpoint_extras/restore_extras across a mid-epoch split: counts
    exactly, sums to 2e-5."""
    r1 = _adaptive_cornell()
    r1.render(11)
    r2 = _adaptive_cornell()
    r2.render(6)
    extras = r2.checkpoint_extras()
    r3 = _adaptive_cornell()
    r3.accum.copy_(r2.accum)
    r3.iteration = r2.iteration
    r3.restore_extras(extras)
    r3.render(5)
    assert (r3.count == r1.count).all()
    np.testing.assert_allclose(r3.accum.numpy(), r1.accum.numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(r3.accum2.numpy(), r1.accum2.numpy(),
                               rtol=2e-5, atol=2e-5)


def test_restore_without_adaptive_state_raises():
    r = _adaptive_cornell()
    with pytest.raises(ValueError, match="adaptive"):
        r.restore_extras({})


@pytest.mark.parametrize("knob", ["sort_materials", "compact", "restir"])
def test_adaptive_refuses_sort_compact_restir(knob):
    value = 8 if knob == "restir" else True
    with pytest.raises(ValueError, match="adaptive"):
        _adaptive_cornell(**{knob: value})


def test_trace_wavefront_refuses_adaptive_with_sort():
    s = _sized(load_scene(CORNELL), 8, 8, 2)
    cfg = dataclasses.replace(PI.build_trace_config(s), adaptive=True,
                              sort_materials=True)
    with pytest.raises(ValueError, match="adaptive"):
        PI.trace_wavefront(s.materials, s.camera.flat(), s.geoms,
                           s.textures, cfg)


def test_adaptive_takes_the_wavefront_and_no_cache():
    r = _adaptive_cornell(first_bounce_cache=True, antialias=False)
    assert r.route == "wavefront" and r._cached_first_hit() is None
