"""portbench's K1 cells, `cornell-render` and `cornell-glass-still`, cut to a
few pixels and bounces and run whole on the CPU (the program's plain
version in K1's place): the result line, a still's reset, the check's
numbers against planted faults and the control, and K1's operation count
on a scene counted by hand.

    JAX_PLATFORMS=cpu python -m pytest tests/test_k1_cells.py
"""
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "portbench")
sys.path[:0] = [p for p in (os.path.join(BENCH, "tests"), BENCH)
                if p not in sys.path]

import control_k1  # noqa: E402
import pb_small  # noqa: E402
from harness import roofline_k1, runner, spec  # noqa: E402
from reference import texenv as TX  # noqa: E402

CELLS = ("cornell-render", "cornell-glass-still")
CPU = torch.device("cpu")
SEED = 2 ** 31 + 29


def _cell(name, iters=3, res=(16, 12), depth=3):
    """The cell cut to `res` and `depth`, `iters` iterations a unit; its
    scene is written under a name of its own (tests in other files write
    the configurations' cuts at once)."""
    c = pb_small.cell(name, res, depth)
    c.config = dict(c.config, name=c.config["name"] + "_k1_cells")
    c.traffic = dict(c.traffic, params=dict(c.traffic["params"],
                                            iterations_per_frame=iters))
    return c


@pytest.mark.parametrize("name", CELLS)
def test_the_cell_resolves_by_name(name):
    c = spec.load_cell(name)
    assert c.chips == 1 and c.mix == "render_k1"
    assert c.config["name"] == dict(zip(CELLS, ("cornell", "cornell_glass"))
                                    )[name]
    assert {m["name"] for m in c.end_to_end} == {
        "render_segments_per_s", "peak_mem_gib", "setup_s"}
    assert {"k1_roofline", "k1_host_ms", "readback_ms", "scene_load_s",
            "readback_copy_ms", "device_busy_pct.render"} == set(c.readers())
    assert set(c.settings["limits"]) == {"image_gap", "mean_gap"}
    still = name == "cornell-glass-still"
    p = c.traffic["params"]
    assert bool(p.get("reset_per_unit")) is still
    assert p["iterations_per_frame"] == (5000 if still else 3600)
    assert c.settings["trace_units"] == (2 if still else 1)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_prints_the_result_line(name, trace):
    c = _cell(name)
    out = runner.run(c, SEED, 0.2, bool(trace), CPU, 0.0)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checks"]) == {"image_gap", "mean_gap"}
    assert all(v["value"] < 1e-6 for v in out["checks"].values())
    json.dumps(out)
    if trace:
        # the host spans are read on the CPU, the device metrics are not
        assert {"readback_ms", "k1_host_ms"} <= set(out["metrics"])
        assert "k1_roofline" not in out["metrics"]
        assert out["metrics"]["k1_host_ms"]["value"] > 0
    else:
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}


def test_a_still_resets_each_unit():
    """Every unit of the still renders iterations 0..n-1 from a zeroed
    accumulator: the image after any number of units is the first's, and a
    preview's is not."""
    imgs = {}
    for name in CELLS:
        c = _cell(name)
        mix = c.mix_module().Mix(runner.Ctx(c, SEED, CPU))
        mix.setup()
        first = mix.image.copy()
        mix.unit()
        mix.unit()
        imgs[name] = (first, mix.image, mix.r.iteration)
    first, last, n = imgs["cornell-glass-still"]
    assert n == 3 and (first == last).all()
    first, last, n = imgs["cornell-render"]
    assert n == 9 and not (first == last).all()


def _darken(monkeypatch, factor):
    """Every K1 iteration's radiance scaled by `factor`: a darkening spread
    over the frame, as ROADMAP F11's (0.29% on cornell, on the card)."""
    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    clean = mk.iteration_plain

    def dark(accum, *args, **kwargs):
        before = accum.clone()
        clean(accum, *args, **kwargs)
        return accum.copy_(before + (accum - before) * factor)
    monkeypatch.setattr(mk, "iteration_plain", dark)


@pytest.mark.parametrize("name", CELLS)
def test_a_thin_bias_fails_the_check(monkeypatch, name):
    """A darkening of every lane by 1.2x `mean_gap`'s limit stays under
    `image_gap`'s limit and fails `mean_gap`'s."""
    c = _cell(name)
    limits = c.settings["limits"]
    _darken(monkeypatch, 1.0 - 1.2 * limits["mean_gap"])
    out = runner.run(c, SEED, 0.2, False, CPU, 0.0)
    gaps = {k: v["value"] for k, v in out["checks"].items()}
    assert gaps["image_gap"] < limits["image_gap"] < 1.0
    assert gaps["mean_gap"] > limits["mean_gap"]
    assert out["correct"] is False and out["failed"] == out["attempted"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    nums = control_k1.render_numbers(_cell(name), SEED, 12, CPU)
    limits = spec.load_cell(name).settings["limits"]
    assert any(nums[k] > limits[k] for k in limits), nums


# a 4x4 camera looking straight at an emissive cube that fills the view,
# with a sphere behind the camera: every camera ray's one segment tests
# both geoms and ends on the light
LIGHT_WALL = """MATERIAL 0
RGB         1 1 1
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   5

MATERIAL 1
RGB         .5 .5 .5
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   0

CAMERA
RES         4 4
FOVY        20
ITERATIONS  1
DEPTH       3
FILE        wall
EYE         0 0 5
LOOKAT      0 0 0
UP          0 1 0

OBJECT 0
cube
material 0
TRANS       0 0 -2
ROTAT       0 0 0
SCALE       20 20 1

OBJECT 1
sphere
material 1
TRANS       0 0 9
ROTAT       0 0 0
SCALE       1 1 1
"""


def test_k1_work_counts_a_scene_by_hand(tmp_path):
    path = tmp_path / "wall.txt"
    path.write_text(LIGHT_WALL)
    ts = TX.load(str(path))
    tab = TX.Tables(ts, "cpu")
    pix = torch.arange(16)
    counts = roofline_k1.segment_counts(tab, pix, 0, 3)
    # every camera ray hits the glowing wall; the sphere lies behind the
    # camera, so its test misses and takes no distance
    zero = [0, 0, 0]
    assert counts == dict(live=[16, 0, 0], hits=[16, 0, 0],
                          cube_wins=[16, 0, 0], sphere_wins=zero,
                          emit=[16, 0, 0], diffuse=zero, mirror=zero,
                          glass=zero, transmit=zero)
    w = roofline_k1.k1_work(16, counts, ["cube", "sphere"], motion=False,
                            lens=False, sampler="stratified",
                            table_floats=roofline_k1.table_floats(2, 2))
    # a segment: the cube's test 44 + 50, the sphere's 44 + 26, the miss
    # test 2, the wall's distance 36, the winner again 52 + 94 + its face
    # 15, the emission 9; a pixel: the camera 32 and 2 lattice draws of 5
    assert w["flops"] == 16 * (94 + 70 + 2 + 36 + 161 + 9) + 16 * (32 + 10)
    assert w["bytes"] == 16 * 24 + 4 * (20 + 2 * 40 + 2 * 16)
    # two segments of one pixel through a moving sphere, the first shading
    # by the diffuse lobe, the second going through the glass
    one = dict(live=[1, 1], hits=[1, 1], cube_wins=[0, 0],
               sphere_wins=[1, 1], emit=[0, 0], diffuse=[1, 0],
               mirror=[0, 0], glass=[0, 0], transmit=[0, 1])
    w = roofline_k1.k1_work(1, one, ["sphere"], motion=True, lens=False,
                            sampler="philox", table_floats=0)
    # tests (70 + 2 + 6 shift) and distances (36 + 3) of both segments;
    # each winner 52 + 6 + 3 + 70 + its normal 4, each shading 23 + 4
    # Philox draws of 1; the lobes 73 and 44 + 44, the transmitted
    # point's shift 3; the camera 32, 2 AA draws, the shutter 1 + 1 draw
    assert w["flops"] == (2 * 78 + 2 * 39 + 2 * 135 + 2 * 27 + 73 + 88 + 3
                          + 36)


def test_the_k1_files_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, 'portbench'); "
            "import control_k1, harness.roofline_k1, mixes.render_k1; "
            "from harness import guard; print(guard.loaded())")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"
