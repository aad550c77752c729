"""The app (app/orbit.py, app/preview.py, the CLI's app flags,
`render_samples` and tools/inverse_demo.py) of the port.

`OrbitState` is held against the JAX `OrbitState` operation by operation
on scenes/cornell.txt's camera. The preview server runs on an ephemeral
port (0) in this process against a 16x16 cornell on the CPU (K1's plain
version: the megakernel route), each server stopped in a `finally`; after
an orbit its next frame equals a fresh Renderer's at the new camera. The
CLI runs in this process on small copies of cornell.
"""
import copy
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.app.orbit import OrbitState as JOrbit
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.app import cli
from project3_cuda_path_tracer_tpu_torch.app.orbit import OrbitState
from project3_cuda_path_tracer_tpu_torch.app.preview import PreviewServer
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from project3_cuda_path_tracer_tpu_torch.utils import image as img_io

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
CORNELL = os.path.join(SCENES, "cornell.txt")
HTTP_TIMEOUT = 60

CAM_FIELDS = ("position", "look_at", "up", "view", "right", "fov",
              "pixel_length")


def _cams():
    return jax_load_scene(CORNELL).camera, load_scene(CORNELL).camera


def _assert_same_cam(pc, jc):
    for f in CAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(pc, f)),
                                      np.asarray(getattr(jc, f)), err_msg=f)


def _assert_same_state(ps, js):
    for f in ("phi", "theta", "zoom", "up_sign"):
        assert getattr(ps, f) == getattr(js, f), f
    np.testing.assert_array_equal(ps.look_at, js.look_at)


OPS = {
    "identity": lambda s, cam: s,
    "rotate": lambda s, cam: s.rotate(0.3, -0.2),
    "rotate_clamped": lambda s, cam: s.rotate(-1.0, 10.0),
    "dolly": lambda s, cam: s.dolly(-2.5),
    "dolly_clamped": lambda s, cam: s.dolly(-1000.0),
    "pan": lambda s, cam: s.pan(0.7, -0.4, cam),
    "recenter": lambda s, cam: s.recenter(),
    "chain": lambda s, cam: s.rotate(0.1, 0.05).dolly(1.0).pan(-0.2, 0.3,
                                                               cam),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_orbit_matches_jax(op):
    """from_camera, the operation, then apply: the same state and the same
    rebuilt camera as the JAX OrbitState, bit for bit."""
    jc, pc = _cams()
    js, ps = JOrbit.from_camera(jc), OrbitState.from_camera(pc)
    _assert_same_state(ps, js)
    js, ps = OPS[op](js, jc), OPS[op](ps, pc)
    _assert_same_state(ps, js)
    _assert_same_cam(ps.apply(pc), js.apply(jc))


def _small_cornell(res=16, depth=2):
    s = load_scene(CORNELL)
    s.camera.resolution = (res, res)
    s.camera.derive()
    s.settings.trace_depth = depth
    return s


def _get(port, path, data=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="POST" if data is not None else "GET")
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


@pytest.fixture
def preview():
    """A preview server on an ephemeral port over a 16x16 cornell."""
    r = Renderer(_small_cornell(), device="cpu")
    assert r.route == "megakernel"
    srv = PreviewServer(r, port=0).start()
    try:
        yield srv
    finally:
        srv.stop()


def test_preview_routes(preview):
    """GET /, /frame.png, /state and POST /orbit; 404 elsewhere."""
    preview.step_many(2)
    code, ctype, body = _get(preview.port, "/")
    assert code == 200 and ctype == "text/html" and b"/frame.png" in body
    code, ctype, body = _get(preview.port, "/frame.png")
    assert code == 200 and ctype == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    code, _, body = _get(preview.port, "/state")
    assert json.loads(body) == {"iteration": 2, "width": 16, "height": 16}
    code, _, body = _get(preview.port, "/orbit?dphi=0.2&dzoom=-1", b"")
    assert code == 200 and json.loads(body) == {"ok": True}
    assert json.loads(_get(preview.port, "/state")[2])["iteration"] == 0
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(preview.port, "/nope")
    assert exc.value.code == 404


def test_preview_frame_after_orbit_is_the_new_camera(preview):
    """After POST /orbit the renderer's next frames equal a fresh
    Renderer's at the orbited camera (K1's table repacked by reset()),
    and differ from the old view's."""
    r = preview.renderer
    preview.step_many(2)
    old = r.image().copy()
    _get(preview.port, "/orbit?dphi=0.4&dtheta=-0.1&dpanx=0.3", b"")
    preview.step_many(2)
    got = r.image()
    cam = copy.deepcopy(r.scene.camera)
    fresh_scene = _small_cornell()
    fresh_scene.camera = cam
    fresh = Renderer(fresh_scene, device="cpu")
    fresh.render(2)
    np.testing.assert_array_equal(got, fresh.image())
    assert np.abs(got - old).max() > 1e-3
    code, _, body = _get(preview.port, "/frame.png")
    want = (np.clip(got, 0, 1) * 255).astype(np.uint8)
    assert body == img_io.encode_png(want)


def test_reset_repacks_the_wavefront_camera():
    """On the wavefront route too: a camera change then reset() renders
    what a fresh Renderer renders at the new camera."""
    s = _small_cornell()
    s.settings.stratified = True
    r = Renderer(s, device="cpu", route="wavefront")
    r.render(1)
    OrbitState.from_camera(s.camera).rotate(0.5, 0.0).apply(s.camera)
    r.reset()
    r.render(1)
    fresh = Renderer(copy.deepcopy(s), device="cpu", route="wavefront")
    fresh.render(1)
    np.testing.assert_array_equal(r.image(), fresh.image())


def _scene_copy(tmp_path, extra=None, res=16):
    with open(CORNELL) as f:
        text = f.read().replace("RES         800 800",
                                f"RES         {res} {res}")
    if extra:
        text = extra(text)
    path = tmp_path / "cornell_small.txt"
    path.write_text(text)
    return str(path)


def test_cli_snapshot_every(tmp_path, capsys):
    scene = _scene_copy(tmp_path)
    rc = cli.main([scene, "--device", "cpu", "--iterations", "4", "--depth",
                   "2", "--outdir", str(tmp_path), "--snapshot-every", "2",
                   "--metrics"])
    err = capsys.readouterr().err
    assert rc == 0, err
    for n in (2, 4):
        assert (tmp_path / f"cornell.snap{n}.png").exists()
    assert (tmp_path / "cornell.png").exists()
    recs = [json.loads(x) for x in err.splitlines() if x.startswith("{")]
    assert [r.get("iteration") for r in recs[:2]] == [2, 4]
    assert recs[-1]["iters"] == 4 and recs[-1]["final"]


def test_cli_timestamp_name(tmp_path, capsys):
    scene = _scene_copy(tmp_path)
    rc = cli.main([scene, "--device", "cpu", "--iterations", "3", "--depth",
                   "2", "--outdir", str(tmp_path), "--timestamp-name"])
    assert rc == 0
    names = [p.name for p in tmp_path.glob("cornell.*.3samp.png")]
    assert len(names) == 1, list(tmp_path.iterdir())
    assert names[0].endswith("Z.3samp.png")


def test_cli_debug_nans_exits_nonzero(tmp_path, capsys):
    """A scene whose light's colour holds a NaN: exit 1 at the first
    iteration, named; the same scene without the flag runs to its end."""
    scene = _scene_copy(tmp_path, lambda t: t.replace(
        "RGB         1 1 1", "RGB         nan 1 1", 1))
    args = [scene, "--device", "cpu", "--iterations", "3", "--depth", "2",
            "--outdir", str(tmp_path)]
    rc = cli.main(args + ["--debug-nans"])
    err = capsys.readouterr().err
    assert rc == 1 and "after iteration 0" in err, err
    assert not (tmp_path / "cornell.png").exists()
    assert cli.main(args) == 0


def test_cli_debug_nans_passes_a_finite_render(tmp_path, capsys):
    scene = _scene_copy(tmp_path)
    rc = cli.main([scene, "--device", "cpu", "--iterations", "2", "--depth",
                   "2", "--outdir", str(tmp_path), "--debug-nans"])
    assert rc == 0 and (tmp_path / "cornell.png").exists()


def test_cli_sharded_one_process(tmp_path, capsys):
    """--sharded in one process: a world of one over gloo (the CPU), the
    wavefront route, and the image of the single-process wavefront
    render; --restir with --sharded exits 2."""
    from project3_cuda_path_tracer_tpu_torch.parallel import sharding
    scene = _scene_copy(tmp_path)
    try:
        rc = cli.main([scene, "--device", "cpu", "--iterations", "2",
                       "--depth", "2", "--outdir", str(tmp_path),
                       "--sharded", "--out", "sh", "--hdr"])
    finally:
        sharding.shutdown()
    err = capsys.readouterr().err
    assert rc == 0, err
    assert "sharded over 1 rank(s)" in err and "route=wavefront" in err
    s = load_scene(scene)
    s.settings.trace_depth = 2
    r = Renderer(s, device="cpu", route="wavefront")
    r.render(2)
    got = img_io.read_hdr(str(tmp_path / "sh.hdr"))
    want = r.image()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-6)
    assert cli.main([scene, "--device", "cpu", "--sharded", "--restir",
                     "4"]) == 2


def test_render_samples():
    """The raw accumulation of a fresh Renderer (not divided)."""
    s = _small_cornell()
    got = PI.render_samples(s, 3, seed=2, device="cpu")
    r = Renderer(_small_cornell(), device="cpu")
    r.render(3, seed=2)
    np.testing.assert_array_equal(got, r.accum.numpy())
    assert got.shape == (16, 16, 3) and float(got.mean()) > 0


def test_render_samples_is_exported():
    """`render_samples` is importable from the package, as the JAX
    package's __init__ exports it."""
    import project3_cuda_path_tracer_tpu as jax_pkg
    import project3_cuda_path_tracer_tpu_torch as pkg
    from project3_cuda_path_tracer_tpu_torch import render_samples
    assert render_samples is PI.render_samples
    assert hasattr(jax_pkg, "render_samples") and hasattr(pkg,
                                                          "render_samples")


def test_inverse_demo_moves_toward_the_true_albedo(tmp_path, capsys):
    """tools/inverse_demo.py on the CPU at 16x16: the albedo moves from
    its perturbed start toward the true white, and the PNGs are
    written."""
    from project3_cuda_path_tracer_tpu_torch.tools import inverse_demo
    rc = inverse_demo.main(["--device", "cpu", "--res", "16", "--steps",
                            "12", "--outdir", str(tmp_path)])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    rec = lines[-1]["recovered_albedo"]
    start = [0.2, 0.6, 0.3]
    assert rec[0] > start[0] and rec[2] > start[2]
    for name in ("target", "initial", "recovered"):
        assert (tmp_path / f"inverse_{name}.png").exists()
