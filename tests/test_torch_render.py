"""The torch port's slice end to end: Renderer, CLI, and the jax-free import.

With `stratified=True` every draw of an iteration is a deterministic hash of
(iteration, depth, pixel), the same in both packages, so the port's
Renderer on the CPU (which runs iteration_plain) must reproduce the JAX
package's render_radiance lane by lane, under the lane contract of
tests/test_torch_megakernel.py. With the pseudo-random samplers the streams
differ, so only image means are compared.
"""
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
from project3_cuda_path_tracer_tpu import Renderer as JaxRenderer
from project3_cuda_path_tracer_tpu.render import integrator as JI
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.app import cli
from project3_cuda_path_tracer_tpu_torch.utils.device import resolve_device
from project3_cuda_path_tracer_tpu_torch.utils.launches import launch_counts
from test_torch_megakernel import assert_lane_contract

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")


def _sized(load, name, res, depth):
    s = load(os.path.join(SCENES, name + ".txt"))
    s.camera.resolution = (res, res)
    s.camera.derive()
    s.settings.trace_depth = depth
    return s


@pytest.mark.parametrize("name", ["cornell", "cornell_dof"])
def test_stratified_render_matches_jax(name):
    """24x24, depth 4, AA on, 2 iterations: the port's Renderer(device=
    "cpu") against JAX render_radiance(iteration=i) summed over i."""
    res, depth, iters = 24, 4, 2
    js = _sized(jax_load_scene, name, res, depth)
    js.settings.stratified = True
    cfg = JI.build_trace_config(js, js.settings)
    render = jax.jit(lambda it: JI.render_radiance(
        js.materials, js.camera.flat(), js.geoms, js.meshes, js.textures,
        jax.random.PRNGKey(0), cfg, iteration=it))
    want = sum(np.asarray(render(jnp.int32(i))) for i in range(iters))

    ps = _sized(load_scene, name, res, depth)
    ps.settings.stratified = True
    r = Renderer(ps, device="cpu")
    got = r.render(iters).numpy()
    assert r.iteration == iters and got.shape == (res, res, 3)
    n = res * res
    assert_lane_contract(got.reshape(n, 3).T, want.reshape(n, 3).T)


def test_pseudo_random_render_mean_matches_jax():
    """32x32, 64 spp, depth 4: the port's torch.Generator stream against the
    JAX default stream. The per-iteration image mean of this scene has a
    standard deviation of ~0.02, so each 64-spp mean has a standard error
    of ~0.0026 and their difference ~0.004; 0.02 is five of those."""
    res, depth, spp = 32, 4, 64
    js = _sized(jax_load_scene, "cornell", res, depth)
    want = np.asarray(JaxRenderer(js).render(spp)).mean(axis=(0, 1)) / spp
    ps = _sized(load_scene, "cornell", res, depth)
    got = Renderer(ps, device="cpu").render(spp).mean(dim=(0, 1)).numpy()
    np.testing.assert_allclose(got / spp, want, atol=0.02)


def test_renderer_counts_no_launches_on_cpu():
    ps = _sized(load_scene, "sphere", 8, 2)
    before = launch_counts()
    r = Renderer(ps, device="cpu")
    r.step_many(3)
    assert r.iteration == 3 and launch_counts() == before
    img = r.image()
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


def test_cuda_device_is_never_substituted():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the error without one")
    with pytest.raises(RuntimeError, match="cuda"):
        Renderer(load_scene(os.path.join(SCENES, "cornell.txt")),
                 device="cuda")
    with pytest.raises(ValueError):
        resolve_device("gpu")


def test_renderer_refuses_unsupported_scene():
    """The features K1 lacks send a scene to the wavefront route: the
    procedural sky (slice D), as the glossy lobe does
    (tests/test_torch_mesh.py), and spectral dispersion (slice E, which
    once raised here; tests/test_torch_dispersion.py renders it)."""
    scene = load_scene(os.path.join(SCENES, "cornell.txt"))
    scene.textures.sky[0] = 1.0
    assert Renderer(scene, device="cpu").route == "wavefront"
    scene = load_scene(os.path.join(SCENES, "cornell.txt"))
    scene.materials.dispersion[0] = 0.05
    r = Renderer(scene, device="cpu")
    assert r.route == "wavefront" and r.cfg.dispersion


def test_port_imports_without_jax():
    """Every module of the port, models/ and tools/ included, imports
    without jax, the JAX package or optax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import project3_cuda_path_tracer_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,\n"
        "                                               p.__name__ + '.')\n"
        "         if not m.name.endswith('__main__')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for want in ('models.inverse', 'models.optim', 'tools.exp_gather',\n"
        "             'tools.exp_extract_cost', 'ops.nee', 'ops.texfetch',\n"
        "             'utils.launches'):\n"
        "    assert p.__name__ + '.' + want in names, want\n"
        "bad = [m for m in sys.modules\n"
        "       if m in ('jax', 'optax') or m.startswith(\n"
        "           ('jax.', 'jaxlib', 'optax.',\n"
        "            'project3_cuda_path_tracer_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cli_end_to_end(tmp_path, capsys):
    with open(os.path.join(SCENES, "cornell.txt")) as f:
        text = f.read().replace("RES         800 800", "RES         32 32")
    scene = tmp_path / "cornell32.txt"
    scene.write_text(text)
    rc = cli.main([str(scene), "--device", "cpu", "--iterations", "2",
                   "--depth", "2", "--outdir", str(tmp_path), "--metrics"])
    assert rc == 0
    png = tmp_path / "cornell.png"
    assert png.exists() and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    rec = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert rec["iters"] == 2 and rec["resolution"] == [32, 32]
    assert rec["trace_depth"] == 2 and rec["output"] == str(png)
    # the program's recorder: K1's route records no span, the CPU
    # captures no graph
    assert rec["spans"] == {} and rec["graph_nodes"] == {}
    # the hand kernels' counts, G1's among them (no tally on the CPU)
    assert "mat_grad" in rec["launches"]
    assert rec["device_launches"]["mat_grad"] == 0


@pytest.mark.parametrize("flag", ["--sharded", "--snapshot-every=4",
                                  "--timestamp-name", "--debug-nans",
                                  "--no-bake", "--megakernel"])
def test_cli_unported_flag_exits_2(flag, capsys):
    """The JAX flags the port does not take (--no-bake, --megakernel, by
    decision) exit 2 and say why; the app's flags are taken now
    (tests/test_torch_app.py runs them)."""
    if flag.split("=")[0] not in cli.UNPORTED_FLAGS:
        args, rest = cli.build_parser().parse_known_args(["s.txt", flag])
        assert rest == []
        return
    rc = cli.main([os.path.join(SCENES, "cornell.txt"), flag])
    assert rc == 2
    assert "ROADMAP" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [("--adaptive", "--sort"),
                                   ("--adaptive", "--compact"),
                                   ("--adaptive", "--restir", "8")])
def test_cli_refuses_adaptive_combinations(flags, capsys):
    """The JAX CLI's refusals: adaptive with sort or compaction, ReSTIR
    with adaptive (exit 2 before any render)."""
    rc = cli.main([os.path.join(SCENES, "cornell.txt"), "--device", "cpu",
                   *flags])
    assert rc == 2
    assert "incompatible" in capsys.readouterr().err


def test_cli_unknown_flag_exits_2():
    with pytest.raises(SystemExit) as exc:
        cli.main([os.path.join(SCENES, "cornell.txt"), "--no-such-flag"])
    assert exc.value.code == 2


# The small emitter scene of the JAX tests/test_restir.py (CLI_SCENE).
EMITTER_SCENE = """MATERIAL 0
RGB 1 1 1
EMITTANCE 5

MATERIAL 1
RGB .6 .6 .6

CAMERA
RES 24 24
FOVY 45
ITERATIONS 4
DEPTH 3
FILE c
EYE 0 2 6
LOOKAT 0 2 0
UP 0 1 0

OBJECT 0
cube
material 0
TRANS 0 6 0
ROTAT 0 0 0
SCALE 2 .2 2

OBJECT 1
cube
material 1
TRANS 0 0 0
ROTAT 0 0 0
SCALE 8 .1 8
"""


def _run_cli(scene, flags, tmp_path, capsys):
    rc = cli.main([str(scene), "--device", "cpu", "--iterations", "2",
                   "--outdir", str(tmp_path), "--out", "nee", "--metrics",
                   *flags])
    err = capsys.readouterr().err
    png = tmp_path / "nee.png"
    assert rc == 0, err
    assert png.exists() and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "route=wavefront" in err and "features dropped" not in err
    rec = json.loads(err.strip().splitlines()[-1])
    assert rec["iters"] == 2 and rec["output"] == str(png)
    # --metrics records the program's spans: a wavefront iteration's
    # host part each iteration
    assert rec["spans"]["render.prepare"]["count"] == 2
    assert rec["spans"]["render.prepare"]["ms"] > 0


@pytest.mark.parametrize("flags", [["--nee"], ["--nee-ris", "2"],
                                   ["--restir", "2"]])
def test_cli_direct_lighting(flags, tmp_path, capsys):
    """--nee, --nee-ris 2 and --restir 2 on the small emitter scene render
    through the wavefront route and write a PNG."""
    scene = tmp_path / "small.txt"
    scene.write_text(EMITTER_SCENE)
    _run_cli(scene, flags, tmp_path, capsys)


@pytest.mark.parametrize("flags", [["--nee", "--stratified"],
                                   ["--nee-ris", "4"],
                                   ["--restir", "2", "--restir-cap", "4"]])
def test_cli_direct_lighting_lights_scene(flags, tmp_path, capsys):
    """scenes/lights.txt (two area lights) at 32x32, depth 2, the same."""
    with open(os.path.join(SCENES, "lights.txt")) as f:
        text = f.read().replace("RES 800 800", "RES 32 32")
    assert "RES 32 32" in text
    scene = tmp_path / "lights32.txt"
    scene.write_text(text)
    _run_cli(scene, ["--depth", "2", *flags], tmp_path, capsys)


def test_cli_nee_drop_is_announced(tmp_path, capsys):
    """--nee on a scene without area lights names the drop on stderr and
    renders plain."""
    from test_torch_nee import NO_LIGHTS
    scene = tmp_path / "dark.txt"
    scene.write_text(NO_LIGHTS)
    rc = cli.main([str(scene), "--device", "cpu", "--iterations", "1",
                   "--outdir", str(tmp_path), "--nee"])
    assert rc == 0
    assert "features dropped: nee" in capsys.readouterr().err
