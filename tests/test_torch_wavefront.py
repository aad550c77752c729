"""Wavefront stages of the torch port against the JAX package's.

Each stage of project3_cuda_path_tracer_tpu_torch/ops/wavefront.py gets the
same inputs (made with numpy from a seed) as its JAX counterpart in
project3_cuda_path_tracer_tpu/ops/wavefront.py. The integer hash and the
stratified lattice must agree bit for bit. Float stages agree to a stated
tolerance: the two are separately compiled float32 programs, and an ulp of
difference can flip a binary decision (nearest-hit ties, slab face picks)
on a few lanes, which then differ wholesale; at most 0.1% may.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.ops import wavefront as jwf
from project3_cuda_path_tracer_tpu.ops.vec import V3 as JV3
from project3_cuda_path_tracer_tpu_torch import load_scene
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
from project3_cuda_path_tracer_tpu_torch.ops.vec import V3

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "scenes")
ATOL = 1e-5
FLIP_FRAC = 0.001


def _scenes(name, res):
    path = os.path.join(SCENES, name + ".txt")
    js, ps = jax_load_scene(path), load_scene(path)
    for s in (js, ps):
        s.camera.resolution = (res, res)
        s.camera.derive()
    return js, ps


def _close(got, want, atol=ATOL, flip_frac=FLIP_FRAC, what=""):
    """Lanes agree to `atol` except at most `flip_frac` of them."""
    g = np.asarray(got, np.float64).reshape(len(got), -1) if isinstance(
        got, (tuple, list)) else np.asarray(got, np.float64)[None]
    w = np.asarray(want, np.float64).reshape(g.shape)
    bad = (np.abs(g - w) > atol).any(axis=0)
    assert bad.mean() <= flip_frac, \
        f"{what}: {int(bad.sum())}/{bad.size} lanes differ"


def _np(v):
    return [np.asarray(c) for c in v]


def _t(v):
    return [c.numpy() for c in v]


def _from_jax(a):
    return torch.from_numpy(np.array(a))


def test_hash01_bitwise():
    rng = np.random.default_rng(0)
    idx = np.concatenate([np.arange(4096), rng.integers(
        0, 2 ** 31 - 1, 4096)]).astype(np.int32)
    for salt in (0, 0x68BC21EB, 0x2545F491 + 303, 0xFFFFFFFF):
        want = np.asarray(jwf._hash01(jnp.asarray(idx), salt))
        got = wf._hash01(torch.from_numpy(idx), salt).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_dims,salt", [(1, 0x3504F333),
                                           (2, 0x68BC21EB),
                                           (4, 0x2545F491)])
def test_stratified_planes_bitwise(num_dims, salt):
    pix = np.arange(2048, dtype=np.int32)
    for iteration in (0, 1, 7, 1000):
        for depth in (0, 3, wf.CAMERA_SLOT):
            want = jwf.stratified_planes(jnp.int32(iteration), depth,
                                         jnp.asarray(pix), num_dims, salt)
            got = wf.stratified_planes(iteration, depth,
                                       torch.from_numpy(pix), num_dims, salt)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["cornell", "cornell_dof"])
def test_generate_rays_stratified(name):
    """Pinhole with stratified AA (cornell) and the thin lens + shutter
    (cornell_dof): every draw is the lattice, so the rays agree to 1e-6."""
    js, ps = _scenes(name, 24)
    dof, motion = name == "cornell_dof", name == "cornell_dof"
    jo, jd, jt, jp = jwf.generate_rays_planar(
        js.camera.flat(), 24, 24, jax.random.PRNGKey(0), antialias=True,
        tile=0, dof=dof, motion=motion, stratified=True,
        iteration=jnp.int32(5))
    po, pd, pt, pp = wf.generate_rays_planar(
        ps.camera.flat(), 24, 24, None, antialias=True, dof=dof,
        motion=motion, stratified=True, iteration=5)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    for g, w in zip(_t(po) + _t(pd) + [pt.numpy()],
                    _np(jo) + _np(jd) + [np.asarray(jt)]):
        np.testing.assert_allclose(g, w, atol=1e-6)


def _random_rays(n, seed):
    """Origins inside the cornell box, directions uniform on the sphere."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 4.5], (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _both(a):
    return (JV3(*(jnp.asarray(a[:, i]) for i in range(3))),
            V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                 for i in range(3))))


@pytest.mark.parametrize("name", ["cornell", "cornell_glass"])
def test_primitive_hits_match(name):
    js, ps = _scenes(name, 16)
    o, d = _random_rays(4096, 1)
    (jo, po), (jd, pd) = _both(o), _both(d)
    times = np.zeros(4096, np.float32)
    for g, gtype in enumerate(int(t) for t in np.asarray(js.geoms.type)):
        jh = jax.jit(lambda a, b, t: jwf._primitive_hit_planar(
            a, b, t, js.geoms, g, gtype))(jo, jd, jnp.asarray(times))
        ph = wf._primitive_hit_planar(po, pd, torch.from_numpy(times),
                                      ps.geoms, g, gtype)
        # attributes of lanes that miss this primitive are never read
        hit = np.asarray(jh.t) < 1e29
        _close([ph.t.numpy()], [np.asarray(jh.t)], what=f"geom {g} t")
        for k in ("normal", "point", "surf"):
            _close([np.where(hit, c, 0) for c in _t(getattr(ph, k))],
                   [np.where(hit, c, 0) for c in _np(getattr(jh, k))],
                   what=f"geom {g} {k}")
        _close([ph.outside.numpy()], [np.asarray(jh.outside)],
               what=f"geom {g} outside")


@pytest.mark.parametrize("name", ["cornell", "cornell_glass"])
def test_intersect_matches(name):
    js, ps = _scenes(name, 16)
    o, d = _random_rays(4096, 2)
    (jo, po), (jd, pd) = _both(o), _both(d)
    times = np.zeros(4096, np.float32)
    gt = tuple(int(t) for t in np.asarray(js.geoms.type))
    jh = jax.jit(lambda a, b, t: jwf.intersect_planar(
        a, b, t, js.geoms, js.meshes, gt))(jo, jd, jnp.asarray(times))
    ph = wf.intersect_planar(po, pd, torch.from_numpy(times), ps.geoms, gt)
    _close([ph.t.numpy()], [np.asarray(jh.t)], what="t")
    _close([ph.mat_id.numpy()], [np.asarray(jh.mat_id)], atol=0, what="mat")
    for k in ("normal", "point", "surf"):
        _close(_t(getattr(ph, k)), _np(getattr(jh, k)), what=k)
    _close([ph.outside.numpy()], [np.asarray(jh.outside)], atol=0,
           what="outside")


@pytest.mark.parametrize("name,glossy", [("cornell", False),
                                         ("cornell_glass", False),
                                         ("cornell_glossy", True)])
def test_shade_matches(name, glossy):
    """shade_planar on the same hit records, ray state and injected
    uniforms as JAX's shade_planar(sky=False)."""
    js, ps = _scenes(name, 16)
    n = 4096
    o, d = _random_rays(n, 3)
    (jo, _), (jd, pd) = _both(o), _both(d)
    gt = tuple(int(t) for t in np.asarray(js.geoms.type))
    jh = jwf.intersect_planar(jo, jd, jnp.zeros(n), js.geoms, js.meshes, gt)
    ph = wf.HitP(t=_from_jax(jh.t),
                 normal=V3(*(_from_jax(c) for c in jh.normal)),
                 mat_id=_from_jax(jh.mat_id).long(),
                 point=V3(*(_from_jax(c) for c in jh.point)),
                 surf=V3(*(_from_jax(c) for c in jh.surf)),
                 u=_from_jax(jh.u), v=_from_jax(jh.v),
                 outside=_from_jax(jh.outside))
    rng = np.random.default_rng(4)
    thr = rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    alive = rng.random(n) < 0.9
    u = rng.random((4, n), dtype=np.float32)
    last = np.zeros(n, bool)
    jthr, pthr = _both(thr)
    jout = jwf.shade_planar(jh, jd, jthr, jnp.asarray(alive), js.materials,
                            js.textures, jnp.asarray(u),
                            last_bounce=jnp.asarray(last), glossy=glossy,
                            sky=False)
    pout = wf.shade_planar(ph, pd, pthr, torch.from_numpy(alive),
                           ps.materials, ps.textures, torch.from_numpy(u),
                           last_bounce=torch.from_numpy(last), glossy=glossy)
    for k in ("origin", "direction", "throughput", "radiance"):
        _close(_t(getattr(pout, k)), _np(getattr(jout, k)), what=k)
    np.testing.assert_array_equal(pout.alive.numpy(), np.asarray(jout.alive))
