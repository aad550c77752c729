"""The port's span and counter recorder (utils/profiling.py) and where the
program records into it.

On the CPU: spans record nothing without a profiler or `recording()`;
inside a profiler a span lies within a `record_function` range around it,
on the profiler's own timestamps (the shared clock); `step()`/`image()`
and `render_chunk` record the render spans, `make_train_scan`'s calls the
train spans (the graph's replay through a stand-in for the capture);
`render_chunk` with spans on makes no host round trip; `image()` is the
host mean bit for bit (on a card too); a textured scene's
decode and upload record `scene.textures` and `render.textures`, and its
captured iteration counts its P1 launches. On a card
(`cuda`-marked, skip here): a span around a synchronised kernel contains
the kernel's profiler interval, and a captured graph's `kernel_nodes`
equals the kernels its replay records. The file imports neither JAX nor
the JAX package:

    python -m pytest tests/test_torch_spans.py --noconftest -m cuda
"""
import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
from project3_cuda_path_tracer_tpu_torch.models import optim
from project3_cuda_path_tracer_tpu_torch.ops import texfetch
from project3_cuda_path_tracer_tpu_torch.render import integrator as I
from project3_cuda_path_tracer_tpu_torch.utils import device as D
from project3_cuda_path_tracer_tpu_torch.utils import profiling
from torch_audit import host_round_trips

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def _names():
    return [n for n, _, _ in profiling.spans()]


def _cornell(res=16, depth=2, **settings):
    scene = load_scene(os.path.join(SCENES, "cornell.txt"))
    scene.camera.resolution = (res, res)
    scene.camera.derive()
    scene.settings.trace_depth = depth
    for k, v in settings.items():
        setattr(scene.settings, k, v)
    return scene


class _Stand:
    """A stand-in for a captured torch.cuda.CUDAGraph (a graph needs the
    card): its replay runs the body eagerly."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()

    def pool(self):
        return id(self)


def _stand_in_capture(fn, device, name="graph", **kwargs):
    return D.CapturedGraph(_Stand(fn), {}, 0.0, 0.0, 0, name)


def test_spans_record_nothing_when_off():
    assert not torch._C._autograd._profiler_enabled()
    cm = profiling.span("off")
    with cm:
        torch.ones(4) + 1
    assert cm is profiling.span("other")   # the shared no-op
    assert profiling.spans() == [] and profiling.span_totals() == {}
    with profiling.recording():
        with profiling.span("on"):
            pass
    with profiling.span("off_again"):
        pass
    assert _names() == ["on"]
    assert profiling.span_totals()["on"][0] == 1


@pytest.mark.parametrize("work", [0, 20000])
def test_span_lies_within_a_profiler_range(work):
    """Inside a profiler session spans record, and a span lies within the
    `record_function` range around it, on the profiler's own timestamps:
    the two share a clock."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            with profiling.span("inner"):
                sum(range(work))
    (name, t0, t1), = profiling.spans()
    outer = [ev for ev in prof.profiler.kineto_results.events()
             if ev.name() == "outer"]
    assert name == "inner" and len(outer) == 1
    s = outer[0].start_ns() * 1e-9
    e = s + outer[0].duration_ns() * 1e-9
    # float seconds near 1.8e9 hold ~0.24 us
    assert s - 1e-6 <= t0 <= t1 <= e + 1e-6
    # no span reached the profiler's records
    assert all(ev.name() != "inner"
               for ev in prof.profiler.kineto_results.events())


def test_spans_from_many_threads_lose_no_count():
    """Threads recording at once (the preview steps on its own thread):
    no span and no count is lost."""
    import sys
    import threading
    threads, n = 16, 2000

    def work():
        for _ in range(n):
            with profiling.span("t"):
                pass
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert profiling.span_totals()["t"][0] == threads * n
    assert len(profiling.spans()) == threads * n


def test_counters_hold_values_whether_or_not_recording():
    profiling.set_counter("g.graph_nodes", 7)
    assert profiling.counters() == {"g.graph_nodes": 7}
    assert profiling.spans() == []


def test_step_and_image_record_the_render_spans():
    """step() records `render.prepare`; image() `readback.copy` and
    `readback.host`, and still returns the mirrored mean."""
    r = Renderer(_cornell(nee=True), device="cpu")
    assert r.route == "wavefront"
    with profiling.recording():
        r.step()
        r.step()
        img = r.image()
    assert _names() == ["render.prepare", "render.prepare",
                        "readback.copy", "readback.host"]
    want = r.accum.numpy()[:, ::-1, :] / 2
    assert (img == want).all()


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_image_is_the_host_mean_bit_for_bit(device):
    """image(), which copies the accumulator once into page-locked memory
    and mirrors whole pixels and divides on the host, equals the host
    copy mirrored and divided by the iteration count in numpy, bit for
    bit, for counts whose reciprocal is inexact; an image handed back
    keeps its values through later calls (the host blocks are reused only
    once it is gone). On the card image() runs no kernel, only the copy
    (a frame's kernels are its iterations')."""
    if device == "cuda":
        _need_card()
    r = Renderer(_cornell(nee=True), device=device)
    gen = torch.Generator(device="cpu").manual_seed(7)
    kept = []
    for n in (3, 7, 282):
        r.accum.copy_(torch.rand(r.accum.shape, generator=gen) * 300)
        r.iteration = n
        want = r.accum.cpu().numpy()[:, ::-1, :] / n
        img = r.image()
        assert img.dtype == np.float32 and (img == want).all()
        kept.append((img, want))
    assert all((img == want).all() for img, want in kept)
    if device == "cuda":
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r.image()
            torch.cuda.synchronize()
        assert _kernels(prof) == []


def test_render_chunk_records_draws_and_replays(monkeypatch):
    """render_chunk's host loop, the graph a stand-in: after the eager
    first iteration and the capture, each iteration records
    `render.prepare`, `render.draws` and `render.replay` in that order."""
    monkeypatch.setattr(I, "capture_graph", _stand_in_capture)
    r = Renderer(_cornell(nee=True), device="cpu")
    I.render_chunk(r, 1)
    with profiling.recording():
        I.render_chunk(r, 3)
    assert r.graph.name == "render" and r.graph.replays == 3
    assert _names() == ["render.prepare", "render.draws",
                        "render.replay"] * 3


def test_render_chunk_with_spans_makes_no_host_round_trip(monkeypatch):
    """With spans recording, the chunk's host loop and the body it
    replays read no device value on the host and copy nothing from it
    (tests/torch_audit.py)."""
    monkeypatch.setattr(I, "capture_graph", _stand_in_capture)
    r = Renderer(_cornell(nee=True, stratified=True), device="cpu")
    I.render_chunk(r, 2)
    with host_round_trips(monkeypatch) as audit:
        with profiling.recording(), audit:
            I.render_chunk(r, 2)
    assert audit.hits == [] and audit.copies == []
    assert profiling.span_totals()["render.replay"][0] == 2


def _capturing_stand_in(fn, device, name="graph", counters=None,
                        **kwargs):
    """A stand-in capture that, as a real one, runs the body's host code
    once and keeps the counters' increase over it as the graph's
    launches."""
    before = dict(counters()) if counters is not None else {}
    fn()
    after = dict(counters()) if counters is not None else {}
    return D.CapturedGraph(_Stand(fn), {k: after[k] - before.get(k, 0)
                                        for k in after}, 0.0, 0.0, 0, name)


def _counted_gather_plain(monkeypatch):
    """P1's plain version counted as the kernel's wrapper counts a launch
    (the CPU launches none); the `p1` counter goes back to its value at the
    test's end, so no later test in the process sees these launches."""
    from project3_cuda_path_tracer_tpu_torch.utils import launches
    from project3_cuda_path_tracer_tpu_torch.utils.launches import count
    monkeypatch.setitem(launches._COUNTS, "p1", launches._COUNTS["p1"])
    plain = texfetch.gather_plain

    def counted(table, idx):
        count("p1")
        return plain(table, idx)
    monkeypatch.setattr(texfetch, "gather_plain", counted)


_TEXTURED = """ENVMAP {assets}/sky.hdr

MATERIAL 0
RGB .9 .9 .9
TEXTURE {assets}/checker.png

MATERIAL 1
RGB .98 .98 .98
SPECRGB .98 .98 .98
REFR 1
REFRIOR 1.5

CAMERA
RES 12 10
FOVY 40
ITERATIONS 5
DEPTH 3
FILE textured
EYE 0 3.2 9
LOOKAT 0 1.6 0
UP 0 1 0

OBJECT 0
cube
material 0
TRANS 0 -0.1 0
SCALE 24 .2 24

OBJECT 1
sphere
material 1
TRANS 2.6 1.1 1.2
SCALE 2.2 2.2 2.2
"""


@pytest.mark.parametrize("textured", [True, False])
def test_texture_spans_and_counters(monkeypatch, tmp_path, textured):
    """A scene with a TEXTURE and an ENVMAP records `scene.textures` (the
    decode in load_scene) and `render.textures` (the upload and fusion in
    the Renderer) once each, and its capture holds the graph's P1
    launches (one fused take of the 512x512 + 512x256 atlas+env table a
    bounce; P1's plain version stands in for the kernel). An untextured
    scene (cornell) holds none."""
    monkeypatch.setattr(I, "capture_graph", _capturing_stand_in)
    _counted_gather_plain(monkeypatch)
    if textured:
        path = tmp_path / "textured.txt"
        path.write_text(_TEXTURED.format(assets=os.path.join(SCENES,
                                                             "assets")))
        with profiling.recording():
            scene = load_scene(str(path))
            scene.settings.stratified = True
            r = Renderer(scene, device="cpu")
    else:
        with profiling.recording():
            r = Renderer(_cornell(depth=3, nee=True), device="cpu")
    assert r.route == "wavefront"
    I.render_chunk(r, 1)
    I.render_chunk(r, 2)
    assert r.graph.replays == 2
    totals = profiling.span_totals()
    assert totals["render.textures"][0] == 1
    if textured:
        assert totals["scene.textures"][0] == 1
        assert r.tables[3].fused_packed.numel() == 512 * 512 + 512 * 256
        assert r.graph.launches["p1"] == 3
    else:
        assert r.graph.launches["p1"] == 0


def test_train_scan_records_the_train_spans(monkeypatch):
    """A make_train_scan call records `train.load`, then per step
    `train.prepare` (and from the capture on `train.replay`, the graph a
    stand-in), then `train.unload`."""
    monkeypatch.setattr(PInv, "capture_graph", _stand_in_capture)
    monkeypatch.setattr(PInv.TrainGraph, "captures",
                        property(lambda s: True))
    scene = _cornell(res=8, depth=2)
    dev = torch.device("cpu")
    cfg = PInv.train_config(scene)
    tables = (I.to_device(scene.geoms, dev), I.to_device(scene.meshes, dev),
              texfetch.fuse(I.to_device(scene.textures, dev)))
    run = PInv.make_train_scan(*tables, cfg, num_steps=2)
    params = PInv.params_from_scene(scene, dev)
    opt = optim.init(PInv.param_leaves(params))
    target = torch.zeros((8, 8, 3))
    params, opt, _ = run(params, opt, 1, target)   # eager, then captured
    with profiling.recording():
        run(params, opt, 2, target)
    assert run.train_graph.graph.name == "train"
    assert _names() == (["train.load"]
                        + ["train.prepare", "train.replay"] * 2
                        + ["train.unload"])


def test_trace_writes_the_spans_on_its_timeline(tmp_path):
    """trace()'s Chrome trace holds the block's spans on the program
    span track, inside the trace's own range of the same block."""
    import json
    from torch.profiler import record_function
    with profiling.trace(str(tmp_path)):
        with record_function("around"):
            with profiling.span("inside"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    with profiling.span("after"):
        pass
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    mine = [ev for ev in events if ev.get("cat") == "program_span"]
    assert [ev["name"] for ev in mine] == ["inside"]
    (around,) = [ev for ev in events if ev.get("name") == "around"]
    assert mine[0]["tid"] == profiling.SPAN_TRACK
    assert around["ts"] - 1 <= mine[0]["ts"]
    assert mine[0]["ts"] + mine[0]["dur"] <= around["ts"] + around["dur"] + 1


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _kernels(prof):
    return [ev for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == torch.autograd.DeviceType.CUDA
            and not ev.name().startswith(("Memcpy", "Memset"))]


@pytest.mark.cuda
def test_span_contains_a_synchronised_kernel_on_card():
    """A span around a synchronised `torch.cuda._sleep` contains the
    kernel's profiler interval to within 0.1 ms: the spans and the
    device's records share a clock."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with profiling.span("sleep"):
            torch.cuda._sleep(5_000_000)
            torch.cuda.synchronize()
    (_, t0, t1), = profiling.spans()
    sleeps = _kernels(prof)   # `_sleep` launches one spin kernel
    assert len(sleeps) == 1
    ks = sleeps[0].start_ns() * 1e-9
    ke = ks + sleeps[0].duration_ns() * 1e-9
    assert ke - ks > 1e-3
    assert t0 - 1e-4 <= ks and ke <= t1 + 1e-4


_OCTAHEDRON = """v 1 0 0
v -1 0 0
v 0 1 0
v 0 -1 0
v 0 0 1
v 0 0 -1
f 1 3 5
f 3 2 5
f 2 4 5
f 4 1 5
f 3 1 6
f 2 3 6
f 4 2 6
f 1 4 6
"""

_MESH_ROOM = """MATERIAL 0
RGB 1 1 1
EMITTANCE 5

MATERIAL 1
RGB .8 .6 .4

CAMERA
RES 64 64
FOVY 45
ITERATIONS 5
DEPTH 4
FILE octa
EYE 0 1 4
LOOKAT 0 0.5 0
UP 0 1 0

OBJECT 0
cube
material 0
TRANS 0 3 0
SCALE 2 .1 2

OBJECT 1
mesh octa.obj
material 1
TRANS 0 0.8 0
ROTAT 0 30 0
"""


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mesh", "nee"])
def test_kernel_nodes_equal_a_replays_kernels_on_card(case, tmp_path):
    """A mesh iteration's and a NEE iteration's graph: `nodes` >=
    `kernel_nodes` > 0, both kept as counters, and the kernels that R
    replays record in a complete trace number R times `kernel_nodes`
    (torch's generator prologue, which the NEE graph's light generator
    runs before each replay, launches none)."""
    _need_card()
    if case == "mesh":
        (tmp_path / "octa.obj").write_text(_OCTAHEDRON)
        (tmp_path / "room.txt").write_text(_MESH_ROOM)
        scene = load_scene(str(tmp_path / "room.txt"))
        scene.settings.stratified = True
    else:
        scene = _cornell(64, 4, nee=True, stratified=True)
    r = Renderer(scene, device="cuda")
    r.step_many(2)
    g = r.graph
    assert g is not None and g.name == "render"
    assert g.nodes >= g.kernel_nodes > 0
    assert profiling.counters()["render.graph_nodes"] == g.nodes
    assert profiling.counters()["render.kernel_nodes"] == g.kernel_nodes
    from torch.profiler import ProfilerActivity, profile
    reps = 3
    for _ in range(3):   # the profiler has been seen to lose records
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                g.replay()
            torch.cuda.synchronize()
        got = len(_kernels(prof))
        if got == reps * g.kernel_nodes:
            break
    assert got == reps * g.kernel_nodes
    assert profiling.span_totals()["render.replay"][0] >= reps


@pytest.mark.cuda
def test_graph_holds_one_p1_launch_a_bounce_on_card(tmp_path):
    """On the card the textured scene's captured iteration holds one P1
    launch a bounce, and each replay runs them (the kernel's own device
    tally)."""
    _need_card()
    from project3_cuda_path_tracer_tpu_torch.utils import launches as L
    path = tmp_path / "textured.txt"
    path.write_text(_TEXTURED.format(assets=os.path.join(SCENES, "assets")))
    scene = load_scene(str(path))
    scene.settings.stratified = True
    r = Renderer(scene, device="cuda")
    r.step_many(1)
    r.step_many(2)
    assert r.graph is not None and r.graph.launches["p1"] == 3
    L.zero_launch_counts()
    r.step_many(2)
    assert L.device_launches()["p1"] == 2 * 3
