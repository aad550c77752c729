"""The torch port's mesh path against the JAX package: the parser's mesh
objects, the mesh hit and the intersect stage, a whole stratified iteration
of scenes/mesh.txt, the Renderer's dispatch and the CLI.

The blob scene is loaded once, by the JAX parser (its Python SAH build is
the slow part), and carried over to the port with the `scene.convert`
helpers, so both packages trace the same tree. With `stratified=True`
every draw of an iteration is a hash of (iteration, depth, pixel), the same
in both packages, so the port's trace must reproduce JAX `render_radiance`
lane by lane under the lane contract of tests/test_torch_megakernel.py.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.ops import wavefront as jwf
from project3_cuda_path_tracer_tpu.ops.vec import V3 as JV3
from project3_cuda_path_tracer_tpu.render import integrator as JI
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.app import cli
from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
from project3_cuda_path_tracer_tpu_torch.ops import pallas_bvh as PPB
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
from project3_cuda_path_tracer_tpu_torch.ops.vec import V3
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from project3_cuda_path_tracer_tpu_torch.utils.launches import launch_counts
from project3_cuda_path_tracer_tpu_torch.scene.convert import (
    mesh_bundle_from_numpy, packed_mesh_from_numpy, scene_from_numpy)
from test_torch_megakernel import assert_lane_contract

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
TORUS = os.path.join(SCENES, "meshes", "torus.obj")
MAT_KEYS = ("color", "specular_exponent", "specular_color", "has_reflective",
            "has_refractive", "ior", "emittance", "dispersion")
GEOM_KEYS = ("type", "material_id", "transform", "inverse_transform",
             "inverse_transpose", "velocity", "mesh_id")


def _port_scene(js):
    """The port's Scene from a JAX scene's tables, meshes and packed
    meshes (as numpy)."""
    mats = {k: np.asarray(getattr(js.materials, k)) for k in MAT_KEYS}
    geoms = {k: np.asarray(getattr(js.geoms, k)) for k in GEOM_KEYS}
    cam = {k: np.asarray(v) for k, v in js.camera.flat().items()}
    meshes = mesh_bundle_from_numpy({
        f.name: np.asarray(getattr(js.meshes, f.name))
        for f in dataclasses.fields(js.meshes)})
    packed = tuple(packed_mesh_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in p._asdict().items()}) for p in js.packed_meshes)
    ps = scene_from_numpy(mats, geoms, cam, resolution=js.camera.resolution,
                          meshes=meshes, packed_meshes=packed)
    ps.settings = dataclasses.replace(
        ps.settings, trace_depth=js.settings.trace_depth,
        stratified=js.settings.stratified)
    return ps


@pytest.fixture(scope="module")
def blob():
    """(JAX scene, port scene) of scenes/mesh.txt, one SAH build."""
    js = jax_load_scene(os.path.join(SCENES, "mesh.txt"))
    return js, _port_scene(js)


def _world_rays(n, seed):
    """Rays from around the camera side of the room aimed at a 5-unit box
    around the blob (world centre (0, 4, 0)): they hit the blob, the floor,
    the back wall and the light. numpy [N, 3] origins and directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-4.0, 1.0, 4.0], [4.0, 9.0, 10.0], (n, 3))
    target = rng.uniform([-2.5, 1.5, -2.5], [2.5, 6.5, 2.5], (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _both(a):
    return (JV3(*(jnp.asarray(a[:, i]) for i in range(3))),
            V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                 for i in range(3))))


def _assert_lanes(got, want, what, atol=1e-4, frac=0.01):
    """got/want: lists of [N] planes; the lanes where any plane differs by
    more than atol are at most `frac` of all."""
    g = np.stack([np.asarray(c, np.float64) for c in got])
    w = np.stack([np.asarray(c, np.float64) for c in want])
    bad = (np.abs(g - w) > atol).any(axis=0)
    assert bad.mean() <= frac, f"{what}: {bad.sum()}/{bad.size} lanes differ"


def _planes(v):
    return [c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
            for c in v]


def test_parser_loads_mesh_objects_like_jax(tmp_path):
    """mesh.txt with its mesh swapped for the torus (absolute path) and a
    second object on the same OBJ: equal geoms and mesh ids (deduplicated
    by path), bundle and packed tables bit for bit."""
    with open(os.path.join(SCENES, "mesh.txt")) as f:
        text = f.read().replace("mesh meshes/blob.obj", f"mesh {TORUS}")
    text += ("\nOBJECT 4\nmesh " + TORUS + "\nmaterial 1\nTRANS 2 1 0\n"
             "ROTAT 0 0 0\nSCALE 1 1 1\n")
    path = tmp_path / "torus_scene.txt"
    path.write_text(text)
    js, ps = jax_load_scene(str(path)), load_scene(str(path))
    assert ps.geoms.mesh_id.tolist() == [-1, -1, -1, 0, 0]
    for k in GEOM_KEYS:
        np.testing.assert_array_equal(getattr(ps.geoms, k).numpy(),
                                      np.asarray(getattr(js.geoms, k)), k)
    for f in dataclasses.fields(js.meshes):
        np.testing.assert_array_equal(getattr(ps.meshes, f.name).numpy(),
                                      np.asarray(getattr(js.meshes, f.name)),
                                      f.name)
    (got,), (want,) = ps.packed_meshes, js.packed_meshes
    assert isinstance(got, P8.PackedMesh8)
    for k in ("nodes", "tris"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)


@pytest.mark.parametrize("bounded", [False, True])
def test_mesh_hit_matches_jax(blob, bounded):
    """`_mesh_hit_packet` of the blob geom against the JAX one, with dead
    lanes and, when `bounded`, a world-space occlusion bound."""
    js, ps = blob
    n = 2048
    o, d = _world_rays(n, seed=1)
    (jo, po), (jd, pd) = _both(o), _both(d)
    rng = np.random.default_rng(2)
    alive = rng.random(n) < 0.9
    bound = rng.uniform(2.0, 12.0, n).astype(np.float32) if bounded else None
    g = 3
    jh = jwf._mesh_hit_packet(
        jo, jd, jnp.zeros(n), js.geoms, js.packed_meshes[0], g,
        meshes=js.meshes, alive=jnp.asarray(alive),
        t_world_bound=None if bound is None else jnp.asarray(bound))
    ph = wf._mesh_hit_packet(
        po, pd, torch.zeros(n), ps.geoms, ps.packed_meshes[0], g,
        t_world_bound=None if bound is None else torch.from_numpy(bound),
        alive=torch.from_numpy(alive))
    jhit, phit = np.asarray(jh.t) < 1e29, ph.t.numpy() < 1e29
    assert jhit.sum() > 300 and not phit[~alive].any()
    assert (jhit == phit).mean() >= 0.995
    both = jhit & phit
    sel = lambda planes: [c[both] for c in planes]  # noqa: E731
    for k in ("normal", "point", "surf"):
        _assert_lanes(sel(_planes(getattr(ph, k))),
                      sel(_planes(getattr(jh, k))), k)
    _assert_lanes(sel([ph.t.numpy(), ph.u.numpy(), ph.v.numpy()]),
                  sel([np.asarray(jh.t), np.asarray(jh.u),
                       np.asarray(jh.v)]), "t, u, v")
    np.testing.assert_array_equal(ph.outside.numpy()[both],
                                  np.asarray(jh.outside)[both])


def test_intersect_matches_jax(blob):
    """intersect_planar over the whole mesh scene (3 cubes, then the blob
    bounded by their nearest hit) against the JAX one."""
    js, ps = blob
    n = 2048
    o, d = _world_rays(n, seed=3)
    (jo, po), (jd, pd) = _both(o), _both(d)
    alive = np.random.default_rng(4).random(n) < 0.95
    gt = tuple(int(t) for t in np.asarray(js.geoms.type))
    mesh_ids = tuple(int(m) for m in np.asarray(js.geoms.mesh_id))
    jh = jwf.intersect_planar(jo, jd, jnp.zeros(n), js.geoms, js.meshes, gt,
                              js.packed_meshes, mesh_ids,
                              alive=jnp.asarray(alive))
    ph = wf.intersect_planar(po, pd, torch.zeros(n), ps.geoms, gt,
                             ps.packed_meshes, mesh_ids,
                             alive=torch.from_numpy(alive))
    mat = ph.mat_id.numpy()
    assert (mat == 2).sum() > 300 and (mat == 1).sum() > 300
    assert (mat == np.asarray(jh.mat_id)).mean() >= 0.99
    _assert_lanes([ph.t.numpy()], [np.asarray(jh.t)], "t")
    for k in ("normal", "point", "surf"):
        _assert_lanes(_planes(getattr(ph, k)), _planes(getattr(jh, k)), k)
    mesh = (mat == 2) & (np.asarray(jh.mat_id) == 2)
    _assert_lanes([ph.u.numpy()[mesh], ph.v.numpy()[mesh]],
                  [np.asarray(jh.u)[mesh], np.asarray(jh.v)[mesh]], "uv")
    assert (ph.outside.numpy() == np.asarray(jh.outside)).mean() >= 0.99


def test_stratified_iteration_matches_jax(blob):
    """mesh.txt at 32x32, depth 3, one stratified iteration: the port's
    trace (Renderer on the CPU, the wavefront route) against JAX
    render_radiance."""
    js, ps = blob
    for s in (js, ps):
        s.camera.resolution = (32, 32)
        s.camera.derive()
        s.settings.trace_depth = 3
        s.settings.stratified = True
    cfg = JI.build_trace_config(js, js.settings)
    want = np.asarray(jax.jit(lambda it: JI.render_radiance(
        js.materials, js.camera.flat(), js.geoms, js.meshes, js.textures,
        jax.random.PRNGKey(0), cfg, packed_meshes=js.packed_meshes,
        iteration=it))(jnp.int32(0)))
    r = Renderer(ps, device="cpu")
    assert r.route == "wavefront"
    got = r.render(1).numpy()
    assert got.shape == (32, 32, 3) and np.isfinite(got).all()
    assert_lane_contract(got.reshape(-1, 3).T, want.reshape(-1, 3).T)


def test_binary_packing_renders_like_bvh8(blob):
    """The integrator dispatches on the packed type: the binary tree
    (pack_all, kernels K3/K4) gives the 8-wide tree's image."""
    _, ps = blob
    ps.camera.resolution = (16, 16)
    ps.camera.derive()
    ps.settings.trace_depth = 3
    ps.settings.stratified = True
    wide = Renderer(ps, device="cpu").render(1).numpy()
    binary = dataclasses.replace(ps, packed_meshes=PPB.pack_all(ps.meshes))
    assert isinstance(binary.packed_meshes[0], PPB.PackedMesh)
    got = Renderer(binary, device="cpu").render(1).numpy()
    assert_lane_contract(got.reshape(-1, 3).T, wide.reshape(-1, 3).T)


def test_renderer_dispatch():
    """The scene decides the route: cornell and glass stay on the
    megakernel; glossy and the procedural sky go to the wavefront
    stages."""
    routes = {name: Renderer(load_scene(os.path.join(SCENES, name + ".txt")),
                             device="cpu").route
              for name in ("cornell", "cornell_glass", "cornell_glossy")}
    assert routes == {"cornell": "megakernel", "cornell_glass": "megakernel",
                      "cornell_glossy": "wavefront"}
    sky = load_scene(os.path.join(SCENES, "cornell.txt"))
    sky.textures.sky[0] = 1.0
    assert Renderer(sky, device="cpu").route == "wavefront"


_TINY_OBJ = """v -0.5 0 -0.5
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

_TINY_SCENE = """MATERIAL 0
RGB 1 1 1
EMITTANCE 5

MATERIAL 1
RGB .8 .6 .4

CAMERA
RES 16 16
FOVY 45
ITERATIONS 3
DEPTH 3
FILE tiny_mesh
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


def _tiny_mesh_scene(tmp_path):
    (tmp_path / "pyramid.obj").write_text(_TINY_OBJ)
    path = tmp_path / "tiny_mesh.txt"
    path.write_text(_TINY_SCENE)
    return str(path)


def test_cli_mesh_scene(tmp_path, capsys):
    scene = _tiny_mesh_scene(tmp_path)
    before = launch_counts()
    rc = cli.main([scene, "--device", "cpu", "--iterations", "2",
                   "--outdir", str(tmp_path), "--metrics"])
    assert rc == 0 and launch_counts() == before
    png = tmp_path / "tiny_mesh.png"
    assert png.exists() and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    rec = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert rec["iters"] == 2 and rec["resolution"] == [16, 16]


def test_mesh_render_loads_no_jax(tmp_path):
    """Importing the port and rendering a mesh scene on the CPU loads no
    jax module and nothing of the JAX package."""
    scene = _tiny_mesh_scene(tmp_path)
    code = (
        "import sys\n"
        "from project3_cuda_path_tracer_tpu_torch import load_scene, "
        "Renderer\n"
        f"r = Renderer(load_scene({scene!r}), device='cpu')\n"
        "img = r.render(2)\n"
        "assert r.route == 'wavefront' and img.sum() > 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(\n"
        "    ('jax.', 'jaxlib', 'project3_cuda_path_tracer_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_trace_config_mesh_ids(blob):
    _, ps = blob
    cfg = PI.build_trace_config(ps)
    assert cfg.mesh_ids == (-1, -1, -1, 0)
    assert not mk.supports(ps)
