"""The port's chunked rendering on the CPU: `Renderer.step_many` through
`render/integrator.render_chunk`, which on the card replays one captured
CUDA graph of the iteration body `Renderer._iterate`.

What the graph needs is held here where it can be: the body, driven as a
replay is driven (`_prepare`, the reseeded persistent generators of
`_draws`, the iteration as a 0-dim tensor), gives bit for bit what the
step() of fresh generators and an int iteration gave, reservoir and
adaptive sums included; it makes no host round trip (the ops that would
sync or copy from the host under a capture); the buffers it reads are
overwritten in place by `reset` and `restore_extras`; the chunk rule is
the JAX package's; the CPU never captures; and `step_many` agrees with the
JAX `Renderer.step_many` (render_chunk) under the lane contract of
tests/test_torch_megakernel.py. The replay itself is held against the
eager loop on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import Renderer as JaxRenderer
from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
from project3_cuda_path_tracer_tpu_torch.render import adaptive as A
from project3_cuda_path_tracer_tpu_torch.render import integrator as I
from test_torch_megakernel import assert_lane_contract
from torch_audit import host_round_trips

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")

# (scene, settings): every knob of the wavefront route that a chunk
# replays, on small frames
CONFIGS = {
    "philox": ("cornell", {}),
    "stratified": ("cornell", dict(stratified=True)),
    "sobol": ("cornell", dict(stratified=True, strat_impl="sobol")),
    "nee": ("cornell", dict(nee=True)),
    "nee_stratified": ("cornell", dict(nee=True, stratified=True)),
    "ris": ("cornell", dict(nee=True, nee_ris=4)),
    "restir": ("cornell", dict(restir=4)),
    "roulette": ("cornell", dict(russian_roulette=True)),
    "clamp": ("cornell", dict(clamp=2.0)),
    "sort_compact": ("cornell", dict(sort_materials=True, compact=True)),
    # epoch 4 over 12 iterations: the replan at 8 is no longer uniform
    "adaptive": ("cornell", dict(adaptive=True, adaptive_epoch=4,
                                 stratified=True)),
    "adaptive_philox": ("cornell", dict(adaptive=True, adaptive_epoch=4)),
}
# further scenes for the host round-trip audit: textures, env NEE and P1,
# the SDF march, dispersion, the batched spheres of many lights
AUDIT_ONLY = {
    "textured_nee": ("textured_env", dict(nee=True, bilinear=True)),
    "sdf": ("sdf", dict(stratified=True)),
    "dispersion": ("dispersion", {}),
    "manylights_restir": ("manylights", dict(restir=4)),
}

_PYRAMID = """v -0.5 0 -0.5
v 0.5 0 -0.5
v 0.5 0 0.5
v -0.5 0 0.5
v 0 1 0
f 1 2 5
f 2 3 5
f 3 4 5
f 4 1 5
f 1 3 2
f 1 4 3
"""

_PYRAMID_SCENE = """MATERIAL 0
RGB 1 1 1
EMITTANCE 5

MATERIAL 1
RGB .8 .6 .4

CAMERA
RES 16 16
FOVY 45
ITERATIONS 5
DEPTH 3
FILE pyramid
EYE 0 1 4
LOOKAT 0 0.5 0
UP 0 1 0

OBJECT 0
cube
material 0
TRANS 0 3 0
SCALE 2 .1 2

OBJECT 1
mesh pyramid.obj
material 1
ROTAT 0 30 0
"""


def _pyramid(tmp_path) -> str:
    (tmp_path / "pyramid.obj").write_text(_PYRAMID)
    path = tmp_path / "pyramid.txt"
    path.write_text(_PYRAMID_SCENE)
    return str(path)


def _scene(load, name, res=24, depth=4, **settings):
    s = load(os.path.join(SCENES, name + ".txt"))
    s.camera.resolution = (res, res)
    s.camera.derive()
    s.settings.trace_depth = depth
    for k, v in settings.items():
        setattr(s.settings, k, v)
    return s


def _renderer(config) -> Renderer:
    name, settings = {**CONFIGS, **AUDIT_ONLY}[config]
    return Renderer(_scene(load_scene, name, **settings), device="cpu",
                    route="wavefront")


def _iterations(r) -> int:
    return 12 if r.cfg.adaptive else 5


def _drive_as_replays(r, n: int) -> None:
    """n iterations driven as render_chunk drives its replays: the host's
    part (`_prepare`, the reseeded generators of `_draws`), then the body
    that the graph holds."""
    for _ in range(n):
        r._prepare()
        r._iterate(*r._draws())
        r.iteration += 1


def _fresh(seed: int, salt: int, it: int) -> torch.Generator:
    gen = torch.Generator()
    gen.manual_seed(mk.seed32(seed ^ salt, it))
    return gen


def _step_before_chunks(r, n: int) -> dict:
    """n iterations as step() took them before the iteration became a
    graph body: a fresh generator each iteration, the iteration an int,
    the reservoir rebound to the trace's new one, the adaptive plan
    replanned from the error image every epoch."""
    cfg = r.cfg
    h, w = cfg.height, cfg.width
    accum = torch.zeros((h, w, 3))
    res = I.init_reservoir(w * h, "cpu") if cfg.restir else None
    accum2 = count = None
    if cfg.adaptive:
        accum2, count = torch.zeros((h, w)), torch.zeros((h, w))
        plan, nxt = A.identity_plan(w, h), r.adaptive_epoch
        cost = A.cost_proxy_image(r.scene, w, h)
    for it in range(n):
        gen = None if cfg.stratified else _fresh(r.seed, 0, it)
        lgen = _fresh(r.seed, I.LIGHT_SALT, it) if cfg.nee else None
        if cfg.adaptive:
            if it >= nxt:
                err = A.error_image(accum, accum2, count).numpy()
                plan, nxt = A.plan_from_err(err, cost=cost), it + \
                    r.adaptive_epoch
            pix, surr, cimg = plan
            img, lum2 = A.render_radiance_adaptive(
                *r.tables, cfg, generator=gen, iteration=it,
                packed_meshes=r.packed_meshes, meshes=r.meshes,
                light_gen=lgen, pix_override=pix, samp_index=surr)
            accum.add_(img)
            accum2.add_(lum2)
            count.add_(torch.as_tensor(cimg))
            continue
        out = I.trace_wavefront(
            *r.tables, cfg, generator=gen, iteration=it,
            packed_meshes=r.packed_meshes, meshes=r.meshes, light_gen=lgen,
            reservoir=res)
        if res is not None:
            out, res = out
        accum.add_(I.to_image(out, cfg))
    return dict(accum=accum, reservoir=res, accum2=accum2, count=count)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_iteration_body_matches_step(config):
    """The body driven as replays are (0-dim iteration tensor, reseeded
    persistent generators, buffers updated in place) against the step()
    of fresh generators and int iterations: accumulation, reservoir,
    adaptive sums and counts bit for bit."""
    r = _renderer(config)
    n = _iterations(r)
    want = _step_before_chunks(r, n)
    _drive_as_replays(r, n)
    assert r.iteration == n
    assert torch.equal(r.accum, want["accum"])
    if r.cfg.restir:
        assert set(r.reservoir) == set(want["reservoir"])
        for k, v in want["reservoir"].items():
            assert torch.equal(r.reservoir[k], v), k
    if r.cfg.adaptive:
        assert torch.equal(r.accum2, want["accum2"])
        assert torch.equal(r._count, want["count"])
        assert float(r._count.max()) > float(r._count.min())  # replanned


@pytest.mark.parametrize("config", list(CONFIGS) + list(AUDIT_ONLY))
def test_iteration_body_makes_no_host_round_trip(config, monkeypatch):
    """After the eager iteration that builds the lazy tables, the body
    runs no op that reads a device value on the host or gathers by a
    mask, and copies nothing from the host: a capture would fail on
    either (tests/torch_audit.py)."""
    r = _renderer(config)
    r.step()
    with host_round_trips(monkeypatch) as audit:
        r._prepare()
        gens = r._draws()
        with audit:
            r._iterate(*gens)
    assert audit.hits == [] and audit.copies == []


def test_mesh_body_makes_no_host_round_trip(tmp_path, monkeypatch):
    """The same audit on a mesh scene, K2's plain traversal skipped (on
    the card the kernel runs there, launched without a host query)."""
    r = Renderer(load_scene(_pyramid(tmp_path)), device="cpu")
    assert r.route == "wavefront"
    r.step()
    with host_round_trips(monkeypatch) as audit:
        r._prepare()
        gens = r._draws()
        with audit:
            r._iterate(*gens)
    assert audit.hits == []


@pytest.mark.parametrize("case", ["cornell", "pyramid"])
def test_step_many_matches_jax(case, tmp_path):
    """The port's step_many(5) on the wavefront route against the JAX
    Renderer.step_many(5) (its render_chunk, or its baked chunk on
    cornell) with stratified draws: lanes to 1e-4, at most 1% diverging,
    means within 0.05 (assert_lane_contract, the port's render tests'
    contract against JAX)."""
    if case == "cornell":
        path, res, depth = os.path.join(SCENES, "cornell.txt"), 16, 4
    else:
        path, res, depth = _pyramid(tmp_path), 16, 3
    scenes = []
    for load in (jax_load_scene, load_scene):
        s = load(path)
        s.camera.resolution = (res, res)
        s.camera.derive()
        s.settings.trace_depth = depth
        s.settings.stratified = True
        scenes.append(s)
    jr = JaxRenderer(scenes[0])
    jr.step_many(5)
    r = Renderer(scenes[1], device="cpu", route="wavefront")
    r.step_many(5)
    assert r.iteration == jr.iteration == 5 and r.graph is None
    n = res * res
    assert_lane_contract(r.accum.numpy().reshape(n, 3).T,
                         np.asarray(jr.accum).reshape(n, 3).T)


@pytest.mark.parametrize("settings,aa", [
    (dict(), True), (dict(first_bounce_cache=True), False),
    (dict(first_bounce_cache=True), True),
    (dict(first_bounce_cache=True, restir=2), False),
    (dict(first_bounce_cache=True, adaptive=True), False)])
def test_chunk_rule_matches_jax(settings, aa):
    """`Renderer.chunkable` is the JAX `chunkable` rule: an active
    first-bounce cache (on, no AA, and neither ReSTIR nor adaptive
    sampling, which have their own chunks in JAX) runs the loop of steps;
    every other wavefront render chunks."""
    def make(load):
        s = _scene(load, "cornell_glossy", res=16, depth=3, **settings)
        s.settings.antialias = aa
        return s
    jr = JaxRenderer(make(jax_load_scene))
    if getattr(jr, "adaptive", False) or getattr(jr, "restir", False):
        want = True
    else:
        want = not (jr.settings.first_bounce_cache
                    and jr._cached_first_hit() is not None)
    r = Renderer(make(load_scene), device="cpu")
    assert r.route == "wavefront"
    assert r.chunkable() == want


def test_megakernel_route_runs_steps():
    """The K1 route never chunks (one launch an iteration already)."""
    r = Renderer(_scene(load_scene, "cornell", res=16, depth=3),
                 device="cpu")
    assert r.route == "megakernel" and not r.chunkable()


def test_cpu_step_many_never_captures(monkeypatch):
    """On CPU tensors step_many is the loop of steps: nothing is captured,
    and it equals step() calls."""
    def refuse(*args, **kwargs):
        raise AssertionError("captured on the CPU")
    monkeypatch.setattr(I, "capture_graph", refuse)
    a, b = _renderer("nee"), _renderer("nee")
    assert a.chunkable()
    a.step_many(4)
    for _ in range(4):
        b.step()
    assert a.graph is None and torch.equal(a.accum, b.accum)


def test_capture_follows_the_first_eager_iteration(monkeypatch):
    """render_chunk's warm-up rule, driven on the CPU with a stand-in for
    the capture (a CUDA graph needs the card): a Renderer's first
    iteration runs eagerly, the next call captures whatever its n (a
    preview's step_many(1) as well) and replays from then on; the result
    equals as many step() calls."""
    class Replayed:
        def __init__(self, fn):
            self.fn, self.replays = fn, 0

        def replay(self):
            self.fn()
            self.replays += 1

    monkeypatch.setattr(I, "capture_graph",
                        lambda fn, device, **kwargs: Replayed(fn))
    a, b = _renderer("nee"), _renderer("nee")
    I.render_chunk(a, 1)
    assert a.graph is None and a.iteration == 1
    I.render_chunk(a, 1)
    assert a.graph.replays == 1 and a.iteration == 2
    I.render_chunk(a, 3)
    assert a.graph.replays == 4 and a.iteration == 5
    for _ in range(5):
        b.step()
    assert I.same_state(a, b)


@pytest.mark.parametrize("config", ["restir", "adaptive"])
def test_reset_and_restore_write_buffers_in_place(config):
    """reset() (an orbit's) and restore_extras (a resume's) overwrite the
    buffers the body reads, camera tensors included, so a captured graph
    keeps reading live tensors; the results equal a fresh Renderer's and
    an uninterrupted render's; a checkpoint of another size raises."""
    r = _renderer(config)
    n = _iterations(r)
    r.step_many(n)
    cam = r.tables[1]
    bufs = [r.accum, *(r.reservoir or {}).values()]
    if r.cfg.adaptive:
        bufs += [r.accum2, r._count, *r._plan]
    ptrs = [b.data_ptr() for b in bufs]
    cam_ptrs = {k: v.data_ptr() for k, v in cam.items()}
    r.scene.camera.position = r.scene.camera.position + np.float32(0.25)
    r.scene.camera.derive()
    r.reset()
    assert [b.data_ptr() for b in bufs] == ptrs
    assert {k: v.data_ptr() for k, v in r.tables[1].items()} == cam_ptrs
    r.step_many(n)
    fresh = Renderer(r.scene, device="cpu", route="wavefront")
    fresh.step_many(n)
    assert torch.equal(r.accum, fresh.accum)

    whole = _renderer(config)
    whole.step_many(n)
    half = _renderer(config)
    half.step_many(n // 2)
    extras, accum = half.checkpoint_extras(), half.accum.clone()
    resumed = _renderer(config)
    kept = [resumed.accum, *(resumed.reservoir or {}).values()]
    resumed.accum.copy_(accum)
    resumed.iteration = n // 2
    resumed.restore_extras(extras)
    assert all(a is b for a, b in zip(
        kept, [resumed.accum, *(resumed.reservoir or {}).values()]))
    resumed.step_many(n - n // 2)
    assert torch.equal(resumed.accum, whole.accum)
    # a checkpoint of another frame size never replaces a buffer
    bad = {k: v[:-1] if np.ndim(v) else v for k, v in extras.items()}
    with pytest.raises(ValueError, match="new Renderer"):
        _renderer(config).restore_extras(bad)
