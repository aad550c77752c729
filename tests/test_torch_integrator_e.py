"""The integrator features of slice E in the torch port: material sort and
compaction, Russian roulette, the per-sample clamp, the first-bounce cache,
the route each knob takes, the CLI flags and the display curves.

Sort and compaction must leave the image unchanged bit for bit (the JAX
package's contract, tests/test_render.py:103-112): the draws follow the
path's pixel, whether stratified or from a generator. Russian roulette is
held against a JAX stratified iteration under the lane contract of
tests/test_torch_megakernel.py (lanes to 1e-4, at most 1% diverge, means
within 0.05) and, in the mean, against no roulette within the 0.02 of the
JAX tests/test_render.py:193. The cache within 1e-5 of the uncached
render (tests/test_render_cache.py). The saved PNGs equal the JAX
package's byte for byte.
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
from project3_cuda_path_tracer_tpu.utils import image as jax_image
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.app import cli
from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as PW
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from project3_cuda_path_tracer_tpu_torch.utils import image as port_image
from test_torch_megakernel import assert_lane_contract

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
CORNELL = os.path.join(SCENES, "cornell.txt")
TORUS = os.path.join(SCENES, "meshes", "torus.obj")

# A small mesh room with four materials: the torus (12,288 triangles,
# kernel K2 on the card), a mirror sphere, the floor and the light.
MESH_ROOM = f"""MATERIAL 0
RGB 1 1 1
EMITTANCE 6

MATERIAL 1
RGB .7 .6 .5

MATERIAL 2
RGB .3 .5 .8

MATERIAL 3
RGB .9 .9 .9
SPECRGB .9 .9 .9
REFL 1

CAMERA
RES 24 24
FOVY 45
ITERATIONS 2
DEPTH 4
FILE mesh_room
EYE 0 3 6
LOOKAT 0 1 0
UP 0 1 0

OBJECT 0
cube
material 0
TRANS 0 5 0
ROTAT 0 0 0
SCALE 3 .2 3

OBJECT 1
mesh {TORUS}
material 2
TRANS -0.8 1.5 0
ROTAT 30 0 0
SCALE 1.5 1.5 1.5

OBJECT 2
cube
material 1
TRANS 0 0 0
ROTAT 0 0 0
SCALE 10 .1 10

OBJECT 3
sphere
material 3
TRANS 1.5 1 0.5
ROTAT 0 0 0
SCALE 1.2 1.2 1.2
"""


@pytest.fixture(scope="module")
def mesh_room(tmp_path_factory):
    path = tmp_path_factory.mktemp("room") / "mesh_room.txt"
    path.write_text(MESH_ROOM)
    return load_scene(str(path))


def _cornell(res=24, depth=4):
    s = load_scene(CORNELL)
    s.camera.resolution = (res, res)
    s.camera.derive()
    s.settings.trace_depth = depth
    return s


def _render(scene, spp, seed=0, **settings):
    st = dataclasses.replace(scene.settings, **settings)
    r = Renderer(scene, settings=st, device="cpu")
    r.render(spp, seed=seed)
    return r


KNOBS = {"sort": dict(sort_materials=True), "compact": dict(compact=True),
         "sort+compact": dict(sort_materials=True, compact=True)}


def _sdf_scene():
    s = load_scene(os.path.join(SCENES, "sdf.txt"))
    s.camera.resolution = (24, 24)
    s.camera.derive()
    s.settings.trace_depth = 4
    return s


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("stratified", [True, False])
@pytest.mark.parametrize("which", ["cornell", "mesh_room", "sdf"])
def test_sorted_render_equals_unsorted(which, stratified, knobs, mesh_room):
    """2 iterations at 24x24 depth 4: the permuted wavefront's image equals
    the identity order's bit for bit (on cornell the identity order runs
    K1's plain version; sdf.txt adds the SDF march, the sphere's and SDFs'
    atan2 and the glossy lobe's pow), and the permutation really moved
    lanes."""
    scene = {"cornell": _cornell, "sdf": _sdf_scene}.get(
        which, lambda: mesh_room)()
    base = _render(scene, 2, seed=5, stratified=stratified,
                   sort_materials=False, compact=False)
    assert base.route == ("megakernel" if which == "cornell"
                          else "wavefront")
    real, moved = PI.compaction.apply_permutation, []

    def spy(tree, perm):
        if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
            moved.append(bool((perm != torch.arange(perm.numel())).any()))
        return real(tree, perm)
    PI.compaction.apply_permutation = spy
    try:
        srt = _render(scene, 2, seed=5, stratified=stratified,
                      **KNOBS[knobs])
    finally:
        PI.compaction.apply_permutation = real
    assert srt.route == "wavefront"
    assert len(moved) == 2 * scene.settings.trace_depth and any(moved)
    assert torch.equal(srt.accum, base.accum)


def test_atan2_and_pow_are_lane_position_invariant():
    """torch's CPU atan2 and pow compute the last lanes of each thread's
    range with a scalar routine that differs from the vector one in the
    last bit; `_atan2`/`_pow` give a lane the same value wherever a
    permutation puts it, as a sorted wavefront needs."""
    g = torch.Generator().manual_seed(0)
    n = 100003
    x = torch.rand(n, generator=g) * 4 - 2
    y = torch.rand(n, generator=g) * 3
    perm = torch.randperm(n, generator=g)
    assert torch.equal(PW._atan2(x, y - 1)[perm],
                       PW._atan2(x[perm], (y - 1)[perm]))
    assert torch.equal(PW._pow(y, x * 30)[perm],
                       PW._pow(y[perm], (x * 30)[perm]))
    np.testing.assert_allclose(PW._atan2(x, y - 1).numpy(),
                               torch.atan2(x, y - 1).numpy(), atol=3e-7)


@pytest.mark.parametrize("stratified", [True, False])
def test_sorted_russian_roulette_equals_unsorted(stratified, mesh_room):
    """Roulette's survival draw follows the pixel too."""
    base = _render(mesh_room, 2, seed=2, stratified=stratified,
                   russian_roulette=True, trace_depth=6)
    srt = _render(mesh_room, 2, seed=2, stratified=stratified,
                  russian_roulette=True, trace_depth=6, sort_materials=True,
                  compact=True)
    assert torch.equal(srt.accum, base.accum)


def test_russian_roulette_iteration_matches_jax():
    """One stratified iteration of cornell at 32x32 depth 6 with roulette
    against JAX render_radiance with it."""
    js = jax_load_scene(CORNELL)
    js.camera.resolution = (32, 32)
    js.camera.derive()
    st = dataclasses.replace(js.settings, trace_depth=6, stratified=True,
                             russian_roulette=True)
    cfg = JI.build_trace_config(js, st)
    want = np.asarray(jax.jit(lambda it: JI.render_radiance(
        js.materials, js.camera.flat(), js.geoms, js.meshes, js.textures,
        jax.random.PRNGKey(0), cfg, iteration=it))(jnp.int32(1)))
    ps = _cornell(32, 6)
    r = Renderer(ps, settings=dataclasses.replace(
        ps.settings, stratified=True, russian_roulette=True), device="cpu")
    assert r.route == "wavefront" and r.cfg.russian_roulette
    r.iteration = 1
    r.step()
    got = r.accum.numpy()
    plain = _render(ps, 1, stratified=True, trace_depth=6).accum.numpy()
    assert not np.array_equal(got, plain)  # paths die
    assert_lane_contract(got.reshape(-1, 3).T, want.reshape(-1, 3).T)


def test_russian_roulette_mean_matches_no_roulette():
    """32x32 depth 8, 64 spp each: roulette changes the variance, not the
    expectation (the JAX test's 0.02 on the image mean)."""
    scene = _cornell(32, 8)
    base = _render(scene, 64, russian_roulette=False,
                   sort_materials=True)
    rr = _render(scene, 64, russian_roulette=True, sort_materials=True)
    assert abs(base.image().mean() - rr.image().mean()) < 0.02
    assert not np.allclose(base.image(), rr.image())


def test_clamp_caps_per_sample_radiance():
    """One iteration with --clamp 0.5 equals min(the unclamped iteration,
    0.5) lane for lane; the light's pixels read 5 unclamped."""
    scene = _cornell()
    free = _render(scene, 1, seed=4, stratified=True, sort_materials=True)
    capped = _render(scene, 1, seed=4, stratified=True, clamp=0.5)
    assert capped.route == "wavefront" and capped.cfg.clamp == 0.5
    assert float(free.accum.max()) > 4.0
    assert float(capped.accum.max()) <= 0.5
    assert torch.equal(capped.accum, torch.clamp(free.accum, max=0.5))


def test_first_bounce_cache_matches_uncached(mesh_room):
    """No AA, 4 iterations: the cached render within 1e-5 of the uncached
    one; the cache is built once, by one traversal of the torus, and every
    later iteration traverses it depth - 1 times (depth 4)."""
    calls = []
    real = P8.traverse8

    def count(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    base = _render(mesh_room, 4, seed=3, antialias=False)
    P8.traverse8 = count
    try:
        r = Renderer(mesh_room, settings=dataclasses.replace(
            mesh_room.settings, antialias=False, first_bounce_cache=True,
            seed=3), device="cpu")
        per_step = []
        for _ in range(4):
            before = len(calls)
            r.step()
            per_step.append(len(calls) - before)
    finally:
        P8.traverse8 = real
    assert r.route == "wavefront" and r._first_hit is not None
    assert per_step == [4, 3, 3, 3]
    np.testing.assert_allclose(r.image(), base.image(), atol=1e-5)


def test_first_bounce_cache_is_none_with_aa_and_restir_refuses_it():
    scene = _cornell()
    r = Renderer(scene, settings=dataclasses.replace(
        scene.settings, first_bounce_cache=True), device="cpu")
    assert r.route == "wavefront" and r._cached_first_hit() is None
    r.step()
    assert r._first_hit is None
    noaa = Renderer(scene, settings=dataclasses.replace(
        scene.settings, first_bounce_cache=True, antialias=False,
        restir=4), device="cpu")
    assert noaa.cfg.restir and noaa.route == "wavefront"
    noaa.step()  # ReSTIR's reservoir keeps the identity order: no cache
    assert noaa._first_hit is None
    fh = noaa._cached_first_hit()
    with pytest.raises(ValueError, match="identity path order"):
        PI.trace_wavefront(*noaa.tables, noaa.cfg, iteration=0,
                           reservoir=noaa.reservoir, first_hit=fh)


@pytest.mark.parametrize("knob,value", [
    (None, None), ("sort_materials", True), ("compact", True),
    ("russian_roulette", True), ("strat_impl", "sobol"), ("clamp", 4.0),
    ("first_bounce_cache", True)])
def test_route_for_each_knob(knob, value):
    """Plain cornell takes K1; each knob K1 lacks sends it to the
    wavefront."""
    scene = _cornell(8, 2)
    st = (scene.settings if knob is None
          else dataclasses.replace(scene.settings, **{knob: value}))
    r = Renderer(scene, settings=st, device="cpu")
    assert r.route == ("megakernel" if knob is None else "wavefront")
    assert PI._megakernel_lacks(r.cfg, st) == (knob is not None)


def test_nee_dropped_and_restir_refused_under_sort(capsys):
    scene = _cornell(8, 2)
    r = Renderer(scene, settings=dataclasses.replace(
        scene.settings, nee=True, sort_materials=True), device="cpu")
    assert not r.cfg.nee and r.drops == [
        "nee (incompatible with sort/compact)"]
    assert "nee (incompatible with sort/compact)" in capsys.readouterr().err
    with pytest.raises(ValueError, match="--restir is incompatible"):
        Renderer(scene, settings=dataclasses.replace(
            scene.settings, restir=4, compact=True), device="cpu")
    with pytest.raises(ValueError, match="nee is incompatible"):
        PI.trace_wavefront(*r.tables, dataclasses.replace(r.cfg, nee=True,
                                                          nee_env=True),
                           iteration=0)


def test_cli_slice_e_flags(tmp_path, capsys):
    with open(CORNELL) as f:
        text = f.read().replace("RES         800 800", "RES         16 16")
    scene = tmp_path / "cornell16.txt"
    scene.write_text(text)
    rc = cli.main([str(scene), "--device", "cpu", "--iterations", "2",
                   "--depth", "3", "--outdir", str(tmp_path), "--sort",
                   "--compact", "--russian-roulette", "--stratified",
                   "--sampler", "sobol", "--clamp", "4", "--gamma", "2.2",
                   "--aces", "--metrics"])
    err = capsys.readouterr().err
    assert rc == 0 and "route=wavefront" in err
    assert (tmp_path / "cornell.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    rc = cli.main([str(scene), "--device", "cpu", "--iterations", "1",
                   "--depth", "2", "--outdir", str(tmp_path), "--gamma", "2",
                   "--aces"])
    assert rc == 0 and "route=megakernel" in capsys.readouterr().err
    args = cli.build_parser().parse_args([str(scene)])
    assert (args.sort, args.compact, args.russian_roulette, args.sampler,
            args.clamp, args.gamma, args.aces) == (
        False, False, False, "lattice", 0.0, 0.0, False)
    for flag in ("--sort", "--compact"):
        rc = cli.main([str(scene), "--device", "cpu", "--restir", "4", flag])
        assert rc == 2
        assert "--restir is incompatible" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main([str(scene), "--sampler", "halton"])


@pytest.mark.parametrize("gamma,aces", [(0.0, False), (2.2, False),
                                        (0.0, True), (2.2, True)])
def test_save_render_curves_match_jax_bytes(gamma, aces, tmp_path):
    """One HDR-ish accumulator (values up to 6 over 3 iterations) written
    by both packages' save_render: the same PNG bytes; Renderer.save passes
    the curves through."""
    acc = np.random.default_rng(7).random((12, 10, 3)).astype(
        np.float32) * 6.0
    want = jax_image.save_render(str(tmp_path / "j"), acc, 3, gamma=gamma,
                                 aces=aces)
    got = port_image.save_render(str(tmp_path / "p"), acc, 3, gamma=gamma,
                                 aces=aces)
    assert open(got, "rb").read() == open(want, "rb").read()
    r = Renderer(_cornell(8, 2), device="cpu")
    r.render(2)
    a = r.save(str(tmp_path / "r"), gamma=gamma, aces=aces)
    b = port_image.save_render(str(tmp_path / "s"), r.accum.numpy(), 2,
                               gamma=gamma, aces=aces)
    assert open(a, "rb").read() == open(b, "rb").read()
