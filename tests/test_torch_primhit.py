"""Kernel I1, the analytic primitives' nearest hit (csrc/prim_hit.cu through
ops/primhit.py), and the route `intersect_planar` gives it.

On the CPU: the plain version (`wavefront.primitive_run_plain`, which
`primhit.nearest` runs for CPU tensors) is the chain `intersect_planar`
ran inline before the kernel, bit for bit, on cornell, mesh.txt's cubes and
textured_env (camera rays with the thin lens and the shutter, bounce-1 rays
from their hit points, occlusion queries under a bound, tangents); the
route's rule, which `primhit.nearest` applies (`primhit.takes`: no input
that takes a gradient, so the train step's camera rays keep the chain),
with the kernel's device set to the CPU and a stand-in for the launch; the
strict `<` merge in geom order across coincident cubes and across a run
split by an SDF geom.

On a card (`cuda`-marked, skipped here): the kernel against the plain
version on the same card, 0 differing lanes on every HitP field, on the
wavefronts a renderer step traces (cornell's nearest hits and NEE shadow
queries, mesh.txt's cubes, textured_env's cube and spheres under the thin
lens, tangents); the whole `intersect_planar` against the chain; ties; and
the render graph's replays bit for bit with step() while the `prim` tally
counts its launches (8 a replay on mesh.txt and textured_env, 15 on cornell
with NEE). The file imports no JAX, so on a card:

    python -m pytest tests/test_torch_primhit.py --noconftest -m cuda
"""
import copy
import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
from project3_cuda_path_tracer_tpu_torch.ops import primhit as I1
from project3_cuda_path_tracer_tpu_torch.ops import vec
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
from project3_cuda_path_tracer_tpu_torch.ops.vec import V3
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from project3_cuda_path_tracer_tpu_torch.scene import types as T
from project3_cuda_path_tracer_tpu_torch.utils import launches

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


_LOADED = {}


def _loaded(name, path=None):
    """scenes/<name>.txt (or `path`) loaded once a process, copied."""
    if name not in _LOADED:
        _LOADED[name] = load_scene(path or os.path.join(SCENES,
                                                        name + ".txt"))
    return copy.deepcopy(_LOADED[name])


def _scene(name, res, tmp_path=None):
    """scenes/<name>.txt at res x res; mesh.txt without its mesh (its three
    cubes) when `tmp_path` is given."""
    path = None
    if tmp_path is not None:
        text = open(os.path.join(SCENES, name + ".txt")).read()
        path = str(tmp_path / (name + "_cubes.txt"))
        with open(path, "w") as f:
            f.write(text[:text.index("// the mesh")])
        name += "_cubes"
    scene = _loaded(name, path)
    scene.camera.resolution = (res, res)
    scene.camera.derive()
    return scene


def _run(types, skip=()):
    return tuple((g, t) for g, t in enumerate(types)
                 if t in (T.CUBE, T.SPHERE) and g not in skip)


def _old_chain(o, d, times, geoms, geom_types, max_t=None, tangents=False):
    """The primitive part of `intersect_planar` as it was written inline
    before the kernel: the miss record, then one `_primitive_hit_planar`
    and one merge a CUBE/SPHERE geom."""
    n = o.x.shape[0]
    z = torch.zeros((n,), dtype=torch.float32, device=o.x.device)
    t_init = (torch.full((n,), wf.BIG, dtype=torch.float32,
                         device=o.x.device)
              if max_t is None else torch.clamp(max_t, max=wf.BIG))
    best = wf.HitP(t=t_init, normal=V3(z, z, z),
                   mat_id=torch.zeros((n,), dtype=torch.int64,
                                      device=o.x.device),
                   point=V3(z, z, z), surf=V3(z, z, z), u=z, v=z,
                   outside=torch.ones((n,), dtype=torch.bool,
                                      device=o.x.device),
                   tan=V3(z, z, z) if tangents else None)

    def merge(best, cand):
        closer = cand.t < best.t
        return wf.HitP(
            t=torch.where(closer, cand.t, best.t),
            normal=vec.where(closer, cand.normal, best.normal),
            mat_id=torch.where(closer, cand.mat_id, best.mat_id),
            point=vec.where(closer, cand.point, best.point),
            surf=vec.where(closer, cand.surf, best.surf),
            u=torch.where(closer, cand.u, best.u),
            v=torch.where(closer, cand.v, best.v),
            outside=torch.where(closer, cand.outside, best.outside),
            tan=(vec.where(closer, cand.tan, best.tan) if tangents
                 else None))

    for g, gtype in enumerate(geom_types):
        if gtype in (T.CUBE, T.SPHERE):
            best = merge(best, wf._primitive_hit_planar(o, d, times, geoms, g,
                                                        gtype, tangents))
    return best, t_init


def _wavefronts(scene, seed=7):
    """(bounce 0, bounce 1, occlusion bound) on the CPU: the stratified camera
    rays of iteration 3 with the lens and shutter draws, then rays from their
    nearest primitive hits' points in seeded directions, and a seeded bound
    for occlusion queries along them."""
    cam = scene.camera.flat()
    w, h = scene.camera.resolution
    o, d, times, _ = wf.generate_rays_planar(cam, w, h, None, stratified=True,
                                             iteration=3)
    types = [int(t) for t in scene.geoms.type]
    hit, _ = _old_chain(o, d, times, scene.geoms, types)
    rng = np.random.default_rng(seed)
    n = o.x.shape[0]
    dd = rng.normal(size=(3, n)).astype(np.float32)
    dd /= np.linalg.norm(dd, axis=0)
    d1 = V3(*(torch.from_numpy(c) for c in dd))
    max_t = torch.from_numpy(rng.uniform(0.0, 15.0, n).astype(np.float32))
    return (o, d, times), (hit.point, d1, times), max_t


@pytest.mark.parametrize("query", ["bounce0", "bounce1", "shadow",
                                   "tangents"])
@pytest.mark.parametrize("name", ["cornell", "mesh", "textured_env"])
def test_plain_run_equals_the_old_inline_chain(name, query, tmp_path):
    scene = _scene(name, 24, tmp_path if name == "mesh" else None)
    types = [int(t) for t in scene.geoms.type]
    b0, b1, max_t = _wavefronts(scene)
    o, d, times = b0 if query == "bounce0" else b1
    max_t = max_t if query == "shadow" else None
    tangents = query == "tangents"
    want, t_init = _old_chain(o, d, times, scene.geoms, types, max_t,
                              tangents)
    run = _run(types)
    plain = wf.primitive_run_plain(
        o, d, times, scene.geoms, run,
        wf.init_hit(o.x.shape[0], "cpu", t_init, tangents), tangents)
    assert I1.differing_lanes(plain, want) == {}
    got = I1.nearest(o, d, times, scene.geoms, run,
                     None if max_t is None else t_init, None, tangents)
    assert I1.differing_lanes(got, want) == {}
    hit = want.t < t_init
    assert 0.05 < float(hit.float().mean()) <= 1.0  # the rays hit things
    if name != "textured_env":   # intersect_planar, meshes aside
        full = wf.intersect_planar(o, d, times, scene.geoms, types,
                                   max_t=max_t, tangents=tangents)
        miss = want.t >= t_init
        assert I1.differing_lanes(full, want._replace(
            t=torch.where(miss, -1.0, want.t),
            mat_id=torch.where(miss, 0, want.mat_id))) == {}


def _camera_rays(params, scene, res=16):
    return wf.generate_rays_planar(params.cam, res, res, None,
                                   stratified=True, iteration=1)[:3]


def _open_route(monkeypatch):
    """The route as on a card, on the CPU: `takes` reads the CPU as the
    kernel's device, and the launch is a stand-in that runs the plain chain
    and records its run. Returns the list of runs."""
    launched, chain = [], wf.primitive_run_plain

    def stand_in(o, d, times, geoms, run, t_init, best, tangents):
        launched.append((run, best is not None))
        if best is None:
            best = wf.init_hit(o.x.shape[0], o.x.device, t_init, tangents)
        return chain(o, d, times, geoms, run, best, tangents)
    monkeypatch.setattr(I1, "DEVICE", "cpu")
    monkeypatch.setattr(I1, "_nearest_kernel", stand_in)
    return launched


def test_takes_reads_the_inputs(monkeypatch):
    """`takes`: CUDA tensors none of which takes a gradient while autograd
    records. Rays from a camera that takes a gradient (the train step's)
    keep the chain; so do a bound, an incoming record or geom transforms
    that take one. Off the card it is always the chain."""
    scene = _scene("cornell", 16)
    params = PInv.params_from_scene(scene, "cpu")
    o, d, times = _camera_rays(params, scene)
    geoms = scene.geoms
    assert not I1.takes(o, d, times, None, None, geoms)   # a CPU tensor
    monkeypatch.setattr(I1, "DEVICE", "cpu")
    assert not I1.takes(o, d, times, None, None, geoms)
    with torch.no_grad():
        assert I1.takes(o, d, times, None, None, geoms)
    assert times.requires_grad   # the shutter is a camera leaf
    assert not I1.takes(V3(*(c.detach() for c in o)),
                        V3(*(c.detach() for c in d)), times, None, None,
                        geoms)
    od = [c.detach() for c in (*o, *d, times)]
    o0, d0, t0 = V3(*od[:3]), V3(*od[3:6]), od[6]
    assert I1.takes(o0, d0, t0, None, None, geoms)
    bound = torch.ones_like(t0, requires_grad=True)
    assert not I1.takes(o0, d0, t0, bound, None, geoms)
    record = wf.init_hit(t0.shape[0], "cpu", None, True)
    assert I1.takes(o0, d0, t0, None, record, geoms)
    assert not I1.takes(o0, d0, t0, None, record._replace(
        u=record.u.clone().requires_grad_(True)), geoms)
    moved = copy.copy(geoms)
    moved.transform = geoms.transform.clone().requires_grad_(True)
    assert not I1.takes(o0, d0, t0, None, None, moved)


def test_train_step_keeps_the_chain(monkeypatch):
    """With the route open as on a card, a render whose camera takes a
    gradient runs the chain once a bounce and never the kernel, and its
    gradient reaches the materials; the same render under no_grad launches
    the kernel once a bounce and gives the same image bit for bit."""
    launched = _open_route(monkeypatch)
    chains, real_chain = [], wf.primitive_run_plain

    def chain_spy(*args, **kwargs):
        chains.append(args[0].x.requires_grad)
        return real_chain(*args, **kwargs)
    monkeypatch.setattr(wf, "primitive_run_plain", chain_spy)
    scene = _scene("cornell", 16)
    scene.settings.trace_depth = 3
    scene.settings.stratified = True
    cfg = PI.build_trace_config(scene)
    params = PInv.params_from_scene(scene, "cpu")
    img = PInv.render_image(params, scene.geoms, scene.meshes,
                            scene.textures, None, cfg, iteration=2)
    assert launched == [] and chains == [True] * 3
    img.sum().backward()
    grad = params.materials.color.grad
    assert grad is not None and bool(torch.isfinite(grad).all())
    assert float(grad.abs().sum()) > 0
    with torch.no_grad():
        again = PInv.render_image(params, scene.geoms, scene.meshes,
                                  scene.textures, None, cfg, iteration=2)
    assert launched == [(_run(cfg.geom_types), False)] * 3
    assert chains == [True] * 3   # the stand-in's chain is not the spy
    assert torch.equal(img.detach(), again)


_TIES = """
MATERIAL 0
RGB 1 1 1
SPECEX 0
SPECRGB 0 0 0
REFL 0
REFR 0
REFRIOR 0
EMITTANCE 5

MATERIAL 1
RGB .8 .2 .2
SPECEX 0
SPECRGB 0 0 0
REFL 0
REFR 0
REFRIOR 0
EMITTANCE 0

MATERIAL 2
RGB .2 .8 .2
SPECEX 0
SPECRGB 0 0 0
REFL 0
REFR 0
REFRIOR 0
EMITTANCE 0

CAMERA
RES 16 16
FOVY 45
ITERATIONS 1
DEPTH 2
FILE ties
EYE 0 2 8
LOOKAT 0 1 0
UP 0 1 0

OBJECT 0
cube
material {first}
TRANS 0 1 0
ROTAT 0 20 0
SCALE 2 2 2
{middle}
OBJECT {last_id}
cube
material {second}
TRANS 0 1 0
ROTAT 0 20 0
SCALE 2 2 2
"""
_SDF = """
OBJECT 1
sdf torus
material 0
PARAMS 0.32 0.11
TRANS 0 6 -6
ROTAT 0 0 0
SCALE 1 1 1
"""


def _ties_scene(tmp_path, first, second, split):
    path = tmp_path / f"ties_{first}_{second}_{int(split)}.txt"
    path.write_text(_TIES.format(first=first, second=second,
                                 middle=_SDF if split else "",
                                 last_id=2 if split else 1))
    return load_scene(str(path))


def _aimed(n, dev="cpu"):
    """Rays from outside the cubes toward their common centre."""
    rng = np.random.default_rng(3)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 5 + [0, 1, 0]
    tgt = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32) + [0, 1, 0]
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    return (V3(*(torch.from_numpy(np.ascontiguousarray(o[:, i])).to(dev)
                 for i in range(3))),
            V3(*(torch.from_numpy(np.ascontiguousarray(d[:, i])).to(dev)
                 for i in range(3))),
            torch.zeros(n, device=dev))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("first,second", [(1, 2), (2, 1)])
def test_ties_keep_the_first_geom(first, second, split, tmp_path,
                                  monkeypatch):
    """Two coincident cubes, one run or two runs around an SDF geom: every
    lane that hits them takes the first cube's material. With the route
    open as on a card, a split run is two launches, the second from the
    first's record merged with the SDF's."""
    scene = _ties_scene(tmp_path, first, second, split)
    cfg = PI.build_trace_config(scene)
    o, d, times = _aimed(512)
    hit = wf.intersect_planar(o, d, times, scene.geoms, cfg.geom_types,
                              sdf_kinds=cfg.sdf_kinds)
    assert bool((hit.t > 0).all())
    assert bool((hit.mat_id == first).all())
    calls = _open_route(monkeypatch)
    with torch.no_grad():
        again = wf.intersect_planar(o, d, times, scene.geoms,
                                    cfg.geom_types, sdf_kinds=cfg.sdf_kinds)
    assert I1.differing_lanes(again, hit) == {}
    if split:
        assert calls == [(((0, T.CUBE),), False), (((2, T.CUBE),), True)]
    else:
        assert calls == [(((0, T.CUBE), (1, T.CUBE)), False)]


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

def _card_scene(name, res, depth=8, **settings):
    """scenes/<name>.txt loaded once (mesh.txt's SAH build takes a while),
    copied and sized."""
    scene = _loaded(name)
    scene.camera.resolution = (res, res)
    scene.camera.derive()
    scene.settings.trace_depth = depth
    scene.settings.stratified = True
    for k, v in settings.items():
        setattr(scene.settings, k, v)
    return scene


def traced_queries(renderer, limit=2):
    """The `intersect_planar` calls of one eager step: up to `limit`
    nearest-hit queries and `limit` occlusion queries, each its (o, d,
    times, geoms, geom_types, keyword arguments) with the tensors cloned."""
    real, nearest, shadow = wf.intersect_planar, [], []

    def spy(o, d, times, geoms, geom_types, *args, **kwargs):
        keep = shadow if kwargs.get("max_t") is not None else nearest
        if len(keep) < limit:
            keep.append((V3(*(c.clone() for c in o)),
                         V3(*(c.clone() for c in d)), times.clone(), geoms,
                         tuple(geom_types), args, dict(kwargs)))
        return real(o, d, times, geoms, geom_types, *args, **kwargs)
    wf.intersect_planar = spy
    try:
        renderer.step()
    finally:
        wf.intersect_planar = real
    torch.cuda.synchronize()
    return nearest, shadow


def kernel_against_plain(query, tangents=None):
    """(kernel record, plain record, differing lanes) of one traced query's
    primitive run, and the same of the whole intersect_planar against its
    chain (the route closed)."""
    o, d, times, geoms, types, args, kw = query
    tangents = kw.get("tangents", False) if tangents is None else tangents
    max_t = kw.get("max_t")
    n = o.x.shape[0]
    t_init = (torch.full((n,), wf.BIG, device=o.x.device) if max_t is None
              else torch.clamp(max_t, max=wf.BIG))
    run = _run(types, set(kw.get("sphere_batch", ())))
    with torch.no_grad():
        got = I1.nearest(o, d, times, geoms, run,
                         None if max_t is None else t_init, None, tangents)
        want = wf.primitive_run_plain(o, d, times, geoms, run,
                                      wf.init_hit(n, o.x.device, t_init,
                                                  tangents), tangents)
    return got, want, I1.differing_lanes(got, want)


def whole_against_chain(query, monkeypatch):
    o, d, times, geoms, types, args, kw = query
    with torch.no_grad():
        launches.zero_launch_counts()
        got = wf.intersect_planar(o, d, times, geoms, types, *args, **kw)
        ran = launches.launch_counts()["prim"]
        monkeypatch.setattr(I1, "takes", lambda *a, **k: False)
        want = wf.intersect_planar(o, d, times, geoms, types, *args, **kw)
        monkeypatch.undo()
    return ran, I1.differing_lanes(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cornell_nee", "mesh", "textured_env",
                                  "tangents"])
def test_kernel_equals_plain_on_card(case, monkeypatch):
    """I1 against the plain chain on the card, 0 differing lanes on every
    field: cornell 800x800 with NEE (bounce 0 and 1, nearest and shadow
    queries), mesh.txt's cubes at 1024x1024, textured_env's cube and
    spheres under the thin lens at 1024x1024, and its bounce-1 rays with
    tangents."""
    _need_card()
    name, res = {"cornell_nee": ("cornell", 800), "mesh": ("mesh", 1024),
                 "textured_env": ("textured_env", 1024),
                 "tangents": ("textured_env", 1024)}[case]
    extra = dict(nee=True) if case == "cornell_nee" else {}
    r = Renderer(_card_scene(name, res, **extra), device="cuda")
    assert r.route == "wavefront"
    nearest, shadow = traced_queries(r)
    assert len(nearest) == 2
    assert len(shadow) == (2 if case == "cornell_nee" else 0)
    queries = nearest + shadow
    for i, q in enumerate(queries):
        got, want, bad = kernel_against_plain(
            q, tangents=True if case == "tangents" else None)
        assert bad == {}, (case, i, bad)
        if case == "tangents":
            assert got.tan is not None
        hit = want.t < (wf.BIG if q[6].get("max_t") is None
                        else torch.clamp(q[6]["max_t"], max=wf.BIG))
        assert float(hit.float().mean()) > 0.01
        ran, bad = whole_against_chain(q, monkeypatch)
        assert ran == 1 and bad == {}, (case, i, ran, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
def test_ties_keep_the_first_geom_on_card(split, tmp_path):
    _need_card()
    scene = _ties_scene(tmp_path, 1, 2, split)
    cfg = PI.build_trace_config(scene)
    geoms = PI.to_device(scene.geoms, torch.device("cuda"))
    o, d, times = _aimed(4096, "cuda")
    launches.zero_launch_counts()
    with torch.no_grad():
        hit = wf.intersect_planar(o, d, times, geoms, cfg.geom_types,
                                  sdf_kinds=cfg.sdf_kinds)
    assert launches.launch_counts()["prim"] == (2 if split else 1)
    assert bool((hit.t > 0).all()) and bool((hit.mat_id == 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case,per_replay", [("cornell_nee", 15),
                                             ("mesh", 8),
                                             ("textured_env", 8)])
def test_render_graph_replays_count_i1_launches_on_card(case, per_replay):
    """The render graph's replays equal step() bit for bit, the capture
    holds `per_replay` I1 launches (one a bounce; with NEE one more a
    shadow query, none after the last bounce), and each replay runs them
    (the device tally)."""
    _need_card()
    name = "cornell" if case == "cornell_nee" else case
    extra = dict(nee=True) if case == "cornell_nee" else {}
    eager = Renderer(_card_scene(name, 64, **extra), device="cuda")
    chunk = Renderer(_card_scene(name, 64, **extra), device="cuda")
    n = 4
    for _ in range(n):
        eager.step()
    launches.zero_launch_counts()
    chunk.step_many(n)
    torch.cuda.synchronize()
    assert PI.same_state(eager, chunk)
    g = chunk.graph
    assert g is not None and g.replays == n - 1
    assert g.launches["prim"] == per_replay
    assert launches.device_launches()["prim"] == n * per_replay
