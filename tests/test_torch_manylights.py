"""The many-light path of the torch port: the batched sphere pass
(ops/wavefront._batched_spheres_planar) and the 256-emitter scene.

The batched pass tests every eligible sphere in [K, N] blocks and keeps
only the running nearest hit, where `intersect_planar` would otherwise
test one sphere geom at a time. It is held against the port's per-geom
sphere tests and against the JAX package's batched pass on the same rays:
a different arithmetic (world-space quadratic against the object-space
one), so hit decisions agree on >= 99.5% of the lanes (grazing rays flip)
and t and materials agree to the JAX test_manylights tolerances where both
hit the same sphere, normals on >= 99.5% of those lanes; against the JAX batched pass, the same
arithmetic (which XLA contracts into FMAs), distances and points agree to
a relative 1e-4 with at most 1% of the lanes diverging. The quadratic
cancels (its discriminant is a difference of two numbers near t^2), so
the surface point carries a relative ~1e-5; the normal, (surf - c) / r,
divides that by r = 0.35 and is held to the JAX test's 2e-3.
"""
import os

import jax.numpy as jnp
import numpy as np
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.ops import wavefront as jwf
from project3_cuda_path_tracer_tpu.ops.vec import V3 as JV3
from project3_cuda_path_tracer_tpu.render import integrator as JI
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
from project3_cuda_path_tracer_tpu_torch.ops.vec import V3
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from project3_cuda_path_tracer_tpu_torch.scene import types as T
from test_torch_megakernel import assert_lane_contract

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")


def _rays(n, seed, scene):
    """Origins uniform in a 20-unit box, aimed within ~0.5 of the scene's
    sphere centres (so most rays meet a light, some graze one), with
    shutter times in [0, 1)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-10, 10, (3, n)).astype(np.float32)
    xf = scene.geoms.transform.numpy()
    centres = xf[scene.geoms.type.numpy() == T.SPHERE][:, :3, 3]
    aim = centres[rng.integers(0, len(centres), n)].T + rng.normal(
        0.0, 0.5, (3, n))
    d = aim - o
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    times = rng.uniform(0, 1, n).astype(np.float32)
    return o, d, times


def test_sphere_batch_eligibility_matches_jax():
    """build_trace_config batches the same geoms as the JAX one: all the
    sphere lights of the many-light scenes, nothing on cornell (one
    sphere, below SPHERE_BATCH_MIN)."""
    for name, count in (("manylights", 12), ("manylights256", 256),
                        ("cornell", 0)):
        path = os.path.join(SCENES, name + ".txt")
        js, ps = jax_load_scene(path), load_scene(path)
        want = JI.build_trace_config(js, js.settings).sphere_batch
        got = PI.build_trace_config(ps).sphere_batch
        assert got == want and len(got) == count


def test_batched_spheres_match_unrolled_and_jax():
    """manylights.txt, 4096 random rays with shutter times: the batched
    pass against the port's per-geom sphere tests and against the JAX
    batched pass (module docstring)."""
    path = os.path.join(SCENES, "manylights.txt")
    js, ps = jax_load_scene(path), load_scene(path)
    spheres = PI.build_trace_config(ps).sphere_batch
    n = 4096
    o, d, times = _rays(n, 1, ps)
    po, pd = V3(*map(torch.from_numpy, o)), V3(*map(torch.from_numpy, d))
    pt = torch.from_numpy(times)
    bat = wf._batched_spheres_planar(po, pd, pt, ps.geoms, spheres)
    ref_t = torch.full((n,), wf.BIG)
    ref = None
    for g in spheres:   # the per-geom sphere tests, merged nearest first
        h = wf._primitive_hit_planar(po, pd, pt, ps.geoms, g, T.SPHERE)
        closer = h.t < ref_t
        ref_t = torch.where(closer, h.t, ref_t)
        ref = h if ref is None else wf.HitP(*(
            wf.vec.where(closer, a, b) if isinstance(a, V3)
            else None if a is None  # HitP.tan, absent without tangents
            else torch.where(closer, a, b) for a, b in zip(h, ref)))
    hit_b = bat.t.numpy() < 1e29
    hit_r = ref.t.numpy() < 1e29
    assert hit_r.mean() > 0.15 and (hit_b == hit_r).mean() >= 0.995
    same = hit_b & hit_r & (bat.mat_id.numpy() == ref.mat_id.numpy())
    assert same.sum() >= 0.995 * (hit_b & hit_r).sum()
    np.testing.assert_allclose(bat.t.numpy()[same], ref.t.numpy()[same],
                               rtol=1e-3, atol=1e-3)
    # the per-geom test takes the normal at the backed-off point, the batch
    # at the surface: grazing rays may differ by more than 2e-3
    nerr = np.abs(np.stack([(a - b).numpy()[same]
                            for a, b in zip(bat.normal, ref.normal)]))
    assert (nerr.max(axis=0) > 2e-3).mean() <= 0.005
    assert (bat.outside.numpy()[same] == ref.outside.numpy()[same]).all()

    jb = jwf._batched_spheres_planar(
        JV3(*map(jnp.asarray, o)), JV3(*map(jnp.asarray, d)),
        jnp.asarray(times), js.geoms, spheres)
    np.testing.assert_array_equal(bat.mat_id.numpy()[hit_b],
                                  np.asarray(jb.mat_id)[hit_b])
    for k in ("t", "normal", "point", "surf"):
        g, w = getattr(bat, k), getattr(jb, k)
        g = np.stack([c.numpy() for c in g]) if k != "t" else g.numpy()[None]
        w = (np.stack([np.asarray(c) for c in w]) if k != "t"
             else np.asarray(w)[None])
        if k == "normal":
            # (surf - c) / r: the surface point's error over r = 0.35
            assert_lane_contract(np.where(hit_b, g, 0.0),
                                 np.where(hit_b, w, 0.0), atol=2e-3)
            continue
        # distances and points reach ~27 units: held relative to their size
        scale = np.maximum(np.abs(w), 1.0)
        assert_lane_contract(np.where(hit_b, g / scale, 0.0),
                             np.where(hit_b, w / scale, 0.0))


def test_intersect_routes_spheres_through_the_batch():
    """intersect_planar with sphere_batch gives the per-geom merge's
    nearest material on >= 99.5% of the lanes over the whole scene (floor,
    back wall and 12 lights)."""
    path = os.path.join(SCENES, "manylights.txt")
    ps = load_scene(path)
    cfg = PI.build_trace_config(ps)
    o, d, _ = _rays(4096, 2, ps)
    po, pd = V3(*map(torch.from_numpy, o)), V3(*map(torch.from_numpy, d))
    z = torch.zeros(4096)
    bat = wf.intersect_planar(po, pd, z, ps.geoms, cfg.geom_types,
                              sphere_batch=cfg.sphere_batch)
    ref = wf.intersect_planar(po, pd, z, ps.geoms, cfg.geom_types)
    assert ((bat.t.numpy() > 0) == (ref.t.numpy() > 0)).mean() >= 0.995
    assert (bat.mat_id.numpy() == ref.mat_id.numpy()).mean() >= 0.995


def test_manylights256_renders_with_ris():
    """scenes/manylights256.txt (256 sphere lights, 258 geoms, 258
    materials) at 16x16 depth 2 with --nee-ris 8: all 256 spheres in the
    batch and in the light table, a finite and positive image."""
    scene = load_scene(os.path.join(SCENES, "manylights256.txt"))
    scene.camera.resolution = (16, 16)
    scene.camera.derive()
    scene.settings.trace_depth = 2
    scene.settings.nee = True
    scene.settings.nee_ris = 8
    r = Renderer(scene, device="cpu")
    assert r.route == "wavefront"
    assert len(r.cfg.sphere_batch) == 256 and len(r.cfg.nee_lights) == 256
    assert r.cfg.nee and r.cfg.nee_ris == 8
    img = r.render(2).numpy()
    assert np.isfinite(img).all() and img.mean() > 0
