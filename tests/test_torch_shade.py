"""Kernel S1, the no-grad shading step (csrc/shade.cu through ops/shade.py),
and the route `shade_planar` gives it.

On the CPU: the kernel's tables (its input and output planes, material
tables and staged rows) agree with ops/shade.py's; no `__global__` name of
csrc/shade.cu is one the benchmark's trace reader counts as a hand kernel
(`portbench/harness/profiling.HAND_KERNELS`), so S1's time stays in
`torch_kernel_ms.render`; the route's rule (`shade.takes`): CPU tensors,
autograd on a material or on the throughput, each unimplemented gate and
each texture layout it does not implement go to the chain, with the
kernel's device set to the CPU; inputs the route admits but the kernel
cannot read (a plane of another dtype or shape, three draws, a table of
another dtype, a `last_bounce` plane) raise in `shade` before any launch,
and a material table too wide to stage is the kernel's all the same; with
the route open as on a card (a stand-in for the launch that runs the
chain), a render takes it once a bounce and gives the chain's image bit
for bit, while a render that takes a gradient never does; `last_bounce`
as a bool equals the plane on the chain.

On a card (`cuda`-marked, skipped here): the kernel against the chain
(`wavefront.shade_plain`) on the card, 0 differing lanes on every output
plane, on bounces 0 and 1 of mesh.txt 1024x1024, cornell 800x800 with NEE
and textured_env 2048x2048 (its fused index too), and again with each
material table widened past the rows one block stages; a render with the route
against one with the route closed, bit for bit; the render graph's replays
bit for bit with step() while the tally counts 8 `shade` launches a replay
in each cell and 8 `shade_index` launches on textured_env. The file imports
no JAX, so on a card:

    python -m pytest tests/test_torch_shade.py --noconftest -m cuda
"""
import copy
import dataclasses
import os
import re

import pytest
import torch

from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
from project3_cuda_path_tracer_tpu_torch.ops import primhit as I1
from project3_cuda_path_tracer_tpu_torch.ops import shade as S1
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
from project3_cuda_path_tracer_tpu_torch.ops.vec import V3
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from project3_cuda_path_tracer_tpu_torch.utils import launches

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
SOURCE = os.path.join(REPO, "project3_cuda_path_tracer_tpu_torch", "csrc",
                      "shade.cu")
# the render cells' scenes: (scene, settings)
CASES = {"mesh": ("mesh", {}), "cornell_nee": ("cornell", dict(nee=True)),
         "textured_env": ("textured_env", {})}

_LOADED = {}


def _scene(case, res, depth=8):
    """The case's scene, loaded once a process, copied, sized, stratified."""
    name, settings = CASES[case]
    if name not in _LOADED:
        _LOADED[name] = load_scene(os.path.join(SCENES, name + ".txt"))
    scene = copy.deepcopy(_LOADED[name])
    scene.camera.resolution = (res, res)
    scene.camera.derive()
    scene.settings.trace_depth = depth
    scene.settings.stratified = True
    for k, v in settings.items():
        setattr(scene.settings, k, v)
    return scene


def _source() -> str:
    with open(SOURCE) as f:
        return f.read()


def _enum(first: str) -> list:
    """The names of csrc/shade.cu's enum that starts with `first`, its
    count last."""
    m = re.search(r"enum : int \{\s*(" + first + r"\b[^}]*)\}", _source())
    assert m, first
    return [w.strip() for w in m.group(1).split(",") if w.strip()]


@pytest.mark.parametrize("first,names", [("T_", S1.IN_PLANES),
                                         ("OX", S1.OUT_PLANES),
                                         ("MCOLOR", S1.TABLES)])
def test_kernel_tables_match_the_wrapper(first, names):
    """Each enum of the kernel lists the wrapper's planes or tables in
    order, its last entry their count; the float planes come first; a
    staged row holds the 19 values the kernel reads."""
    entries = _enum(first)
    assert len(entries) == len(names) + 1
    if first == "T_":
        assert entries.index("MATID") == S1.FLOAT_PLANES
        assert S1.IN_PLANES[S1.FLOAT_PLANES] == "mat_id"
    assert re.search(r"constexpr int ROW = (\d+);", _source()).group(
        1) == "19"


def _kernel_names() -> list:
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)", _source())


def test_kernel_names_are_not_hand_kernels():
    """S1's kernels count in `torch_kernel_ms.render`: none of their names,
    alone or as the profiler spells a template instance, matches a regex
    of the trace reader's HAND_KERNELS."""
    from portbench.harness import profiling
    names = _kernel_names()
    assert names == ["shade_kernel", "shade_index_kernel"]
    for name in names:
        for spelled in (name, f"void (anonymous namespace)::{name}<true, "
                              "false, true>((anonymous namespace)::Params)"):
            assert profiling.hand_kernel(spelled) == "", spelled


# ---------------------------------------------------------------------------
# The route on the CPU
# ---------------------------------------------------------------------------

def _traced_calls(r, limit=2):
    """The `shade_planar` calls of one eager step: (args, kwargs) of the
    first `limit`."""
    real, calls = wf.shade_planar, []

    def spy(*args, **kwargs):
        if len(calls) < limit:
            calls.append((args, dict(kwargs)))
        return real(*args, **kwargs)
    wf.shade_planar = spy
    try:
        r.step()
    finally:
        wf.shade_planar = real
    return calls


def _takes(args, kwargs, **over):
    kw = dict(kwargs, **over)
    return S1.takes(*args[:7], kw.get("nee"), kw.get("glossy", True),
                    kw.get("nee_area", 0.0), kw.get("sky", False),
                    kw.get("nee_env_c", 0.0), kw.get("nee_q", 1.0),
                    kw.get("bump", False), kw.get("nmap", False),
                    kw.get("bilinear", False), kw.get("dispersion", False))


_CALLS = {}


def _case_call(case):
    """The bounce-1 `shade_planar` call of a CPU step of the case at 16x16
    (traced with the route closed, whatever a test has opened)."""
    if case not in _CALLS:
        r = Renderer(_scene(case, 16), device="cpu")
        device, S1.DEVICE = S1.DEVICE, "cuda"
        try:
            _CALLS[case] = _traced_calls(r)[1]
        finally:
            S1.DEVICE = device
    return _CALLS[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_takes_reads_the_inputs(case, monkeypatch):
    """`takes`: off the card always the chain; with the CPU as the kernel's
    device, a render's step is the kernel's, under no_grad and with
    autograd recording but no input taking a gradient; a material or the
    throughput taking one keeps the chain while autograd records."""
    args, kwargs = _case_call(case)
    assert not _takes(args, kwargs)   # CPU tensors
    monkeypatch.setattr(S1, "DEVICE", "cpu")
    assert _takes(args, kwargs)
    with torch.no_grad():
        assert _takes(args, kwargs)
    mats = copy.copy(args[4])
    mats.color = mats.color.clone().requires_grad_(True)
    graded = args[:4] + (mats,) + args[5:]
    assert not _takes(graded, kwargs)
    with torch.no_grad():
        assert _takes(graded, kwargs)
    thr = V3(*(c.clone().requires_grad_(True) for c in args[2]))
    assert not _takes(args[:2] + (thr,) + args[3:], kwargs)


# each gate the kernel does not implement, as shade_planar's keywords
_GATES = {"glossy": dict(glossy=True), "sky": dict(sky=True),
          "bump": dict(bump=True), "nmap": dict(nmap=True),
          "bilinear": dict(bilinear=True),
          "dispersion": dict(dispersion=True),
          "nee_env": dict(nee_env_c=0.5), "nee_mixed": dict(nee_q=0.5),
          "nee_without_area": dict(nee_area=0.0)}


@pytest.mark.parametrize("gate", sorted(_GATES))
def test_unimplemented_gates_keep_the_chain(gate, monkeypatch):
    """Each static gate S1 does not implement, set on an otherwise taken
    step, sends it to the chain (the NEE ones on cornell's NEE step)."""
    monkeypatch.setattr(S1, "DEVICE", "cpu")
    case = "cornell_nee" if gate.startswith("nee") else "mesh"
    args, kwargs = _case_call(case)
    assert _takes(args, kwargs)
    assert not _takes(args, kwargs, **_GATES[gate])


def _layouts(tx):
    """Texture layouts built from textured_env's textures: name -> (the
    textures, whether S1 implements them)."""
    one = torch.zeros((1,), dtype=torch.int32)
    flat = torch.zeros((1, 1, 3))
    na = tx.atlas.shape[0] * tx.atlas.shape[1]
    ne = tx.env.shape[0] * tx.env.shape[1]
    rep = dataclasses.replace
    fused = rep(tx, fused_packed=torch.zeros((na + ne,), dtype=torch.int32))
    return {
        "fused": (fused, True),
        "none": (rep(tx, atlas=flat, env=flat, atlas_packed=one,
                     env_packed=one, fused_packed=one), True),
        "atlas_alone": (rep(fused, env=flat, env_packed=one,
                            fused_packed=one), False),
        "env_alone": (rep(fused, atlas=flat, atlas_packed=one,
                          fused_packed=one), False),
        "unfused": (rep(fused, fused_packed=one), False),
        "float32_atlas": (rep(fused, atlas_packed=one), False)}


@pytest.mark.parametrize("name", ["fused", "none", "atlas_alone",
                                  "env_alone", "unfused", "float32_atlas"])
def test_texture_layouts(name, monkeypatch):
    """S1 takes no atlas and no env map (the constant env) or the fused
    nearest atlas+env table; an atlas or env map alone, a scene whose fused
    table is missing and float32 takes keep the chain."""
    monkeypatch.setattr(S1, "DEVICE", "cpu")
    args, kwargs = _case_call("textured_env")
    tx, want = _layouts(args[5])[name]
    assert (S1.layout(tx) is not None) == want
    assert _takes(args[:5] + (tx,) + args[6:], kwargs) == want


def _malformed(args, kind):
    """The call's args with one input the kernel does not read as it is."""
    hit = args[0]
    if kind == "mat_id_int32":
        return (hit._replace(mat_id=hit.mat_id.int()),) + args[1:]
    if kind == "t_float64":
        return (hit._replace(t=hit.t.double()),) + args[1:]
    if kind == "alive_2d":
        return args[:3] + (args[3][:, None],) + args[4:]
    if kind == "three_uniforms":
        return args[:6] + (tuple(args[6])[:3],) + args[7:]
    mats = copy.copy(args[4])
    mats.ior = mats.ior.double()
    return args[:4] + (mats,) + args[5:]


def _no_launch(*args):
    raise AssertionError("the kernel was reached")


@pytest.mark.parametrize("kind", ["mat_id_int32", "t_float64", "alive_2d",
                                  "three_uniforms", "ior_float64"])
def test_malformed_inputs_raise(kind, monkeypatch):
    """A plane of another dtype or shape, three draws or a table of another
    dtype: the route is taken, and `shade` raises before it loads the
    kernel, through `shade_planar` as well."""
    monkeypatch.setattr(S1, "DEVICE", "cpu")
    monkeypatch.setattr(S1, "_kernel_lib", _no_launch)
    args, kwargs = _case_call("cornell_nee")
    bad = _malformed(args, kind)
    assert _takes(bad, kwargs)
    with pytest.raises(ValueError):
        S1.shade(*bad[:7], False, kwargs["nee"], kwargs["nee_area"])
    with pytest.raises(ValueError):
        wf.shade_planar(*bad[:7], **kwargs)


def test_last_bounce_plane_raises_on_the_route(monkeypatch):
    """The kernel takes the last bounce as a Python bool: an [N] plane
    raises TypeError in `shade` and in `shade_planar` on the route, and
    runs the chain off it."""
    monkeypatch.setattr(S1, "_kernel_lib", _no_launch)
    args, kwargs = _case_call("mesh")
    kw = dict(kwargs, last_bounce=torch.zeros_like(args[3]))
    wf.shade_planar(*args[:7], **kw)
    monkeypatch.setattr(S1, "DEVICE", "cpu")
    with pytest.raises(TypeError):
        S1.shade(*args[:7], kw["last_bounce"])
    with pytest.raises(TypeError):
        wf.shade_planar(*args[:7], **kw)


def _widened(args, rows=600):
    """The call's args with every material table repeated to more than
    `rows` rows (past the 512 one block stages) and each lane on its
    material's last copy: the same step, read from rows past the 512th."""
    hit, mats, tx = args[0], args[4], args[5]
    m = mats.color.shape[0]
    copies = rows // m + 1
    wide = lambda t: None if t is None else torch.cat([t] * copies)  # noqa
    mats = dataclasses.replace(mats, **{
        f.name: wide(getattr(mats, f.name))
        for f in dataclasses.fields(mats)})
    tx = dataclasses.replace(tx, **{
        k: wide(getattr(tx, k)) for k in ("tex_id", "bump", "nrm_id",
                                          "rect", "checker_scale",
                                          "checker_color2", "nrm_rect")})
    hit = hit._replace(mat_id=hit.mat_id + m * (copies - 1))
    return (hit,) + args[1:4] + (mats, tx) + args[6:]


@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_material_table_takes_the_kernel(case, monkeypatch):
    """More materials than one block stages (the kernel then reads each
    lane's row from global memory) take the route, and the widened step is
    the chain's step bit for bit."""
    monkeypatch.setattr(S1, "DEVICE", "cpu")
    args, kwargs = _case_call(case)
    wide = _widened(args)
    assert wide[4].color.shape[0] > 512
    assert _takes(wide, kwargs)
    a = wf.shade_plain(*args[:7], **kwargs)
    b = wf.shade_plain(*wide[:7], **kwargs)
    assert I1.differing_lanes(a, b) == {}


def _open_route(monkeypatch):
    """The route as on a card, on the CPU: `takes` reads the CPU as the
    kernel's device, and the launch is a stand-in that runs the chain and
    records whether it had NEE and the fused texel. Returns the list."""
    launched = []

    def stand_in(hit, ray_d, throughput, alive, materials, textures,
                 uniforms, last_bounce, nee=None, nee_area=0.0):
        launched.append((nee is not None, bool(S1.layout(textures)),
                         last_bounce))
        return wf.shade_plain(hit, ray_d, throughput, alive, materials,
                              textures, uniforms, last_bounce, glossy=False,
                              nee=nee, nee_area=nee_area)
    monkeypatch.setattr(S1, "DEVICE", "cpu")
    monkeypatch.setattr(S1, "shade", stand_in)
    return launched


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_takes_the_route_once_a_bounce(case, monkeypatch):
    """With the route open as on a card, a step shades through the kernel's
    entry once a bounce, with the Python bool of the last bounce, and gives
    the chain's image bit for bit."""
    want = Renderer(_scene(case, 16), device="cpu")
    want.step()
    launched = _open_route(monkeypatch)
    got = Renderer(_scene(case, 16), device="cpu")
    got.step()
    nee, tex = case == "cornell_nee", case == "textured_env"
    assert launched == [(nee, tex, d == 7) for d in range(8)]
    assert PI.same_state(got, want)


def test_train_render_keeps_the_chain(monkeypatch):
    """A render whose materials take a gradient shades through the chain
    every bounce, and its gradient reaches the materials; the same render
    under no_grad takes the route and gives the same image bit for bit."""
    launched = _open_route(monkeypatch)
    scene = _scene("cornell_nee", 16, depth=3)
    scene.settings.nee = False
    cfg = PI.build_trace_config(scene)
    params = PInv.params_from_scene(scene, "cpu")
    img = PInv.render_image(params, scene.geoms, scene.meshes,
                            scene.textures, None, cfg, iteration=2)
    assert launched == []
    img.sum().backward()
    grad = params.materials.color.grad
    assert grad is not None and float(grad.abs().sum()) > 0
    with torch.no_grad():
        again = PInv.render_image(params, scene.geoms, scene.meshes,
                                  scene.textures, None, cfg, iteration=2)
    assert len(launched) == 3
    assert torch.equal(img.detach(), again)


@pytest.mark.parametrize("last", [False, True])
def test_last_bounce_bool_equals_its_plane(last):
    """`last_bounce` as a Python bool gives the outputs of the [N] plane."""
    args, kwargs = _case_call("cornell_nee")
    n = args[0].t.shape[0]
    plane = torch.full((n,), last, dtype=torch.bool)
    a = wf.shade_plain(*args[:7], **dict(kwargs, last_bounce=last))
    b = wf.shade_plain(*args[:7], **dict(kwargs, last_bounce=plane))
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert all(torch.equal(p, q) for p, q in zip(x, y))
        else:
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def kernel_against_chain(call):
    """(S1's ShadeOutP, the chain's, differing lanes) of one traced
    `shade_planar` call, and the fused index against the chain's where the
    layout is fused (None else)."""
    args, kwargs = call
    with torch.no_grad():
        assert _takes(args, kwargs)
        got = S1.shade(*args[:7], kwargs["last_bounce"], kwargs.get("nee"),
                       kwargs.get("nee_area", 0.0))
        want = wf.shade_plain(*args[:7], **kwargs)
        index_bad = None
        tx = args[5]
        if S1.layout(tx):
            hit, ray_d = args[0], args[1]
            idx = S1.fused_index(hit, ray_d, args[4], tx)
            aflat, _ = wf._atlas_flat_index(tx, hit.mat_id, hit.u, hit.v)
            na = tx.atlas.shape[0] * tx.atlas.shape[1]
            chain = torch.where(hit.t <= 0.0,
                                wf._env_flat_index(tx, ray_d) + na, aflat)
            index_bad = int((idx != chain).sum())
    torch.cuda.synchronize()
    return got, want, I1.differing_lanes(got, want), index_bad


_CARD_RES = {"mesh": 1024, "cornell_nee": 800, "textured_env": 2048}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_chain_on_card(case):
    """S1 against the chain on the card, 0 differing lanes on every output
    plane (and the fused index on every lane), on bounces 0 and 1 of the
    render cells' scenes at their sizes."""
    _need_card()
    r = Renderer(_scene(case, _CARD_RES[case]), device="cuda")
    assert r.route == "wavefront"
    calls = _traced_calls(r)
    assert len(calls) == 2
    for b, call in enumerate(calls):
        got, want, bad, index_bad = kernel_against_chain(call)
        assert bad == {}, (case, b, bad)
        assert index_bad in ((0,) if case == "textured_env" else (None,))
        assert float(want.alive.float().mean()) > 0.05
        assert (want.nee_pdf is not None) == (case == "cornell_nee")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_material_table_equals_chain_on_card(case):
    """With every material table widened past the rows one block stages
    (each lane reading its row from global memory), S1 against the chain
    on the card: 0 differing lanes, the fused index too, on bounces 0 and
    1 at 256x256."""
    _need_card()
    r = Renderer(_scene(case, 256), device="cuda")
    for b, (args, kwargs) in enumerate(_traced_calls(r)):
        wide = _widened(args)
        assert wide[4].color.shape[0] > 512
        got, want, bad, index_bad = kernel_against_chain((wide, kwargs))
        assert bad == {}, (case, b, bad)
        assert index_bad in ((0,) if case == "textured_env" else (None,))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_render_equals_the_chain_on_card(case, monkeypatch):
    """Two eager steps with the route, against two with the route closed:
    the same accumulation bit for bit; 8 `shade` launches a step (and 8
    `shade_index` on textured_env) by the wrapper and the device tally,
    none with the route closed."""
    _need_card()
    got = Renderer(_scene(case, 64), device="cuda")
    want = Renderer(_scene(case, 64), device="cuda")
    launches.zero_launch_counts()
    for _ in range(2):
        got.step()
    torch.cuda.synchronize()
    ran, counted = launches.device_launches(), launches.launch_counts()
    tex = 16 if case == "textured_env" else 0
    assert (ran["shade"], ran["shade_index"]) == (16, tex)
    assert (counted["shade"], counted["shade_index"]) == (16, tex)
    monkeypatch.setattr(S1, "takes", lambda *a, **k: False)
    launches.zero_launch_counts()
    for _ in range(2):
        want.step()
    torch.cuda.synchronize()
    assert launches.device_launches()["shade"] == 0
    assert PI.same_state(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_render_graph_replays_count_s1_launches_on_card(case):
    """The render graph's replays equal step() bit for bit, the capture
    holds 8 `shade` launches (one a bounce; 8 `shade_index` more on
    textured_env), and each replay runs them (the device tally)."""
    _need_card()
    eager = Renderer(_scene(case, 64), device="cuda")
    chunk = Renderer(_scene(case, 64), device="cuda")
    n = 4
    for _ in range(n):
        eager.step()
    launches.zero_launch_counts()
    chunk.step_many(n)
    torch.cuda.synchronize()
    assert PI.same_state(eager, chunk)
    g = chunk.graph
    assert g is not None and g.replays == n - 1
    tex = 8 if case == "textured_env" else 0
    assert (g.launches["shade"], g.launches["shade_index"]) == (8, tex)
    ran = launches.device_launches()
    assert (ran["shade"], ran["shade_index"]) == (n * 8, n * tex)
