"""The port's CUDA kernels against their plain torch versions, on a card.

K1 (csrc/megakernel.cu) and K2 (csrc/bvh8.cu) in both schedules, K2's
any-hit mode on the shadow rays of a NEE iteration, K3 in both schedules
and both node-row layouts and K4 (csrc/bvh_binary.cu), the probes P1/P2
(csrc/gather.cu, csrc/extract_cost.cu) and P1 as the texture path's
fetch (ops/texfetch.py), a NEE iteration and a textured iteration on
the card against the CPU, K2 on a sorted and compacted wavefront with
the sorted render against the unsorted one (slice E), and the render
services (slice F): K2 on an adaptive wavefront, an adaptive iteration
against the CPU, and resumed renders (adaptive, K1, ReSTIR) against
uninterrupted ones; and the chunked render (`Renderer.step_many` replaying
one captured iteration): replays against the eager loop with K2 (nearest
and any-hit), K3 and P1 in the graph and through the sharded renderer,
replays after reset() and restore_extras, and a failing capture that
raises. Every test here
is `cuda`-marked and skips without a card. The file imports neither JAX
nor the JAX package, so it runs where they are absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

(`--noconftest`: tests/conftest.py sets up JAX's CPU backend). The plain
versions are held against the JAX package in the other test_torch_*.py
files; chip_smoke.py holds the kernels against them at the main path's
shapes.
"""
import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
from project3_cuda_path_tracer_tpu_torch.ops import matgrad as MG
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
from project3_cuda_path_tracer_tpu_torch.ops import pallas_bvh as PPB
from project3_cuda_path_tracer_tpu_torch.ops import texfetch
from project3_cuda_path_tracer_tpu_torch.render.integrator import (
    build_trace_config, same_state)
from project3_cuda_path_tracer_tpu_torch.scene import bvh as PB
from project3_cuda_path_tracer_tpu_torch.tools import exp_extract_cost as P2
from project3_cuda_path_tracer_tpu_torch.tools import exp_gather
from project3_cuda_path_tracer_tpu_torch.utils import launches
from project3_cuda_path_tracer_tpu_torch.utils.launches import launch_counts


import torch_matgrad_cases as MGC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
TORUS = os.path.join(SCENES, "meshes", "torus.obj")


def assert_lane_contract(got, want, atol=1e-4, mismatch_frac=0.01,
                         mean_tol=0.05):
    """got/want: [3, N] radiance planes (x, y, z). Lanes agree to `atol`,
    at most `mismatch_frac` of them diverge, channel means within
    `mean_tol` (tests/test_megakernel.py's contract)."""
    for g, w in zip(np.asarray(got, np.float64), np.asarray(want, np.float64)):
        bad = int((np.abs(g - w) > atol).sum())
        assert bad <= mismatch_frac * g.size, f"{bad}/{g.size} lanes disagree"
        assert abs(g.mean() - w.mean()) < mean_tol, \
            f"means diverge: {g.mean():.4f} vs {w.mean():.4f}"


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _cornell(res):
    scene = load_scene(os.path.join(SCENES, "cornell.txt"))
    scene.camera.resolution = (res, res)
    scene.camera.derive()
    return scene


def _uniforms(seed, depth, n, dev):
    rng = np.random.default_rng(seed)
    cam_u = torch.from_numpy(rng.random((mk.CAM_DIMS, n),
                                        dtype=np.float32)).to(dev)
    u = torch.from_numpy(rng.random((depth, 4, n), dtype=np.float32)).to(dev)
    return cam_u, u


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against iteration_plain on injected uniforms (needs a
    card and nvcc; the full check at the main path's shapes is
    chip_smoke.py)."""
    _need_card()
    scene = _cornell(64)
    cfg = build_trace_config(scene)
    dev = torch.device("cuda")
    table = mk.pack_scene(scene, dev)
    n = 64 * 64
    cam_u, u = _uniforms(0, cfg.trace_depth, n, dev)
    before = launch_counts()["k1"]
    got = mk.iteration(torch.zeros((64, 64, 3), device=dev), table, cfg, 0,
                       0, "uniforms", cam_u, u)
    want = mk.iteration_plain(torch.zeros((64, 64, 3), device=dev), table,
                              cfg, 0, 0, "uniforms", cam_u, u)
    torch.cuda.synchronize()
    assert launch_counts()["k1"] == before + 1
    assert_lane_contract(got.reshape(n, 3).T.cpu().numpy(),
                         want.reshape(n, 3).T.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", sorted(mk.SAMPLERS))
def test_schedules_equal_bitwise_on_card(sampler):
    """The persistent schedule (the renderer's) and the grid schedule give
    equal accumulators bit for bit at 128x128 depth 8, and each holds the
    lane contract against iteration_plain where the draws can match (the
    plain version's Philox stream is torch's, not the kernel's)."""
    _need_card()
    res = 128
    scene = _cornell(res)
    cfg = build_trace_config(scene)
    dev = torch.device("cuda")
    table = mk.pack_scene(scene, dev)
    n = res * res
    cam_u = u = None
    if sampler == "uniforms":
        cam_u, u = _uniforms(4, cfg.trace_depth, n, dev)
    args = (table, cfg, 3, 5, sampler, cam_u, u)
    before = launch_counts()
    pers = mk.iteration(torch.zeros((res, res, 3), device=dev), *args)
    grid = mk._iteration_grid(torch.zeros((res, res, 3), device=dev), *args)
    torch.cuda.synchronize()
    after = launch_counts()
    assert (after["k1"], after["k1_grid"]) == (before["k1"] + 2,
                                               before["k1_grid"] + 1)
    assert torch.equal(pers, grid) and float(pers.sum()) > 0
    if sampler != "philox":
        want = mk.iteration_plain(torch.zeros((res, res, 3), device=dev),
                                  *args).reshape(n, 3).T.cpu().numpy()
        for got in (pers, grid):
            assert_lane_contract(got.reshape(n, 3).T.cpu().numpy(), want)


def _aimed_rays(n, seed, dev):
    """Rays from random origins on a radius-3 sphere aimed near the centre
    (the generator of tests/test_bvh8.py), as (x, y, z) planes on `dev`."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n)).astype(np.float32)
    o /= np.linalg.norm(o, axis=0, keepdims=True)
    o *= 3.0
    target = rng.uniform(-0.4, 0.4, size=(3, n)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return tuple(tuple(torch.from_numpy(np.ascontiguousarray(c)).to(dev)
                       for c in a) for a in (o, d))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K2, K3 and K4 against their plain versions on the card (needs a card
    and nvcc; chip_smoke.py runs the full checks on the blob): K2 on >= 99%
    of the lanes, K3 and K4 bit for bit, node visits included."""
    _need_card()
    dev = torch.device("cuda")
    torus = PB.build_mesh_bundle([TORUS])
    o, d = _aimed_rays(8192, 6, dev)
    p8 = P8.PackedMesh8(*(t.to(dev) for t in P8.pack_mesh8(torus)))
    pb = PPB.PackedMesh(*(t.to(dev) for t in PPB.pack_mesh(torus)))
    got = P8.traverse8(o, d, p8, return_pops=True)
    want = P8.traverse8_plain(o, d, p8)
    torch.cuda.synchronize()
    assert (got[4] == want[4]).float().mean() >= 0.99
    assert (got[5] == want[5]).float().mean() >= 0.99
    plain = PPB.traverse_binary_plain(o, d, pb)
    for sub in (False, True):
        k = PPB.traverse(o, d, pb, sub_packets=sub, return_steps=True)
        torch.cuda.synchronize()
        assert _same_bits(k, plain)
    assert int((plain[4] >= 0).sum()) > 2000


def _k2_inputs(dev):
    """The torus packed 8-wide on `dev`, and 4,096 aimed rays of which some
    start inside its box and some are dead (t_bound -1, 0 and NaN)."""
    torus = PB.build_mesh_bundle([TORUS])
    p8 = P8.PackedMesh8(*(t.to(dev) for t in P8.pack_mesh8(torus)))
    o, d = _aimed_rays(4096, 7, dev)
    o = tuple(torch.where(torch.arange(4096, device=dev) % 5 == 0, 0.3 * c,
                          c) for c in o)
    tb = torch.full((4096,), 1e30, device=dev)
    tb[::7], tb[3::11], tb[5::13] = -1.0, 0.0, float("nan")
    return p8, o, d, tb


def _same_bits(a, b):
    fa = torch.stack([a[0], *a[1], a[2], a[3]]).view(torch.int32)
    fb = torch.stack([b[0], *b[1], b[2], b[3]]).view(torch.int32)
    return (torch.equal(fa, fb) and torch.equal(a[4], b[4])
            and torch.equal(a[5], b[5]))


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_k2_schedules_equal_bitwise_on_card(any_hit):
    """K2's persistent instance (traverse8, the renderer's) and its grid
    instance (the first port's one thread per ray) give t, normal, uv, tri
    and pops bit for bit on the torus, dead lanes included, and each is
    counted under its own key; they match the plain version."""
    _need_card()
    dev = torch.device("cuda")
    p8, o, d, tb = _k2_inputs(dev)
    before = launch_counts()
    pers = P8.traverse8(o, d, p8, t_bound=tb, any_hit=any_hit,
                        return_pops=True)
    grid = P8._traverse8_grid(o, d, p8, t_bound=tb, any_hit=any_hit,
                              return_pops=True)
    want = P8.traverse8_plain(o, d, p8, t_bound=tb, any_hit=any_hit)
    torch.cuda.synchronize()
    after = launch_counts()
    assert (after["k2"], after["k2_any_hit"], after["k2_other"]) == (
        before["k2"] + 1, before["k2_any_hit"] + int(any_hit),
        before["k2_other"] + 1)
    assert _same_bits(pers, grid)
    assert int((pers[4] >= 0).sum()) > 1000
    assert (pers[4] == want[4]).float().mean() >= 0.99
    assert (pers[5] == want[5]).float().mean() >= 0.99
    dead = ~(tb > 0)
    assert (pers[4][dead] == -1).all() and (pers[5][dead] == 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_k2_small_stack_equal_bitwise_on_card(any_hit):
    """The instance with a 2-entry shared stack, whose deeper entries
    overflow to local memory, equals the default instance bit for bit."""
    _need_card()
    dev = torch.device("cuda")
    p8, o, d, tb = _k2_inputs(dev)
    stats = torch.zeros((3,), dtype=torch.int64, device=dev)
    before = launch_counts()
    tiny = P8._traverse8_tiny(o, d, p8, tb, any_hit, True, stats=stats)
    main = P8.traverse8(o, d, p8, t_bound=tb, any_hit=any_hit,
                        return_pops=True)
    torch.cuda.synchronize()
    after = launch_counts()
    assert (after["k2"], after["k2_other"]) == (before["k2"] + 1,
                                                before["k2_other"] + 1)
    assert int(stats[2]) > 2  # the stack did overflow
    assert 0 < int(stats[0]) <= int(stats[1])
    assert _same_bits(tiny, main)


@pytest.mark.cuda
def test_k2_grid_runs_on_card():
    """`_traverse8_grid` runs on the card without the aimed-ray bound and
    matches the plain version."""
    _need_card()
    dev = torch.device("cuda")
    p8, o, d, _ = _k2_inputs(dev)
    got = P8._traverse8_grid(o, d, p8, return_pops=True)
    want = P8.traverse8_plain(o, d, p8)
    torch.cuda.synchronize()
    assert (got[4] == want[4]).float().mean() >= 0.99
    assert (got[5] == want[5]).float().mean() >= 0.99
    hit = (got[4] == want[4]) & (got[4] >= 0)
    assert torch.allclose(got[0][hit], want[0][hit], atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["gather", "extract_cost"])
def test_probe_kernels_match_plain_on_card(probe):
    """On the card: the kernels equal their plain versions bit for bit."""
    _need_card()
    if probe == "gather":
        table, _, idx = exp_gather.inputs(256, n=1 << 20)
        got = texfetch.gather(table, idx)
        want = texfetch.gather_plain(table, idx)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        table, state = P2.inputs()
        for kind in P2.KINDS:
            assert torch.equal(P2.extract_cost(table, state, kind, 64),
                               P2.extract_cost_plain(table, state, kind, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("case", MGC.CASES, ids=MGC.IDS)
def test_mat_grad_kernel_matches_plain_on_card(case):
    """G1 (csrc/mat_grad.cu) equals `mat_grad_plain` bit for bit on the
    CPU's cases (tests/torch_matgrad_cases.py), and a second run equals
    the first: one wrapper count and one device tally a call."""
    _need_card()
    ids, planes, m = MGC.make(case, "cuda")
    want = MG.mat_grad_plain(ids.cpu(), [None if p is None else p.cpu()
                                         for p in planes], m)
    launches.zero_launch_counts()
    got = MG.mat_grad(ids, planes, m)
    again = MG.mat_grad(ids, planes, m)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    assert launches.launch_counts()["mat_grad"] == 2
    assert launches.device_launches()["mat_grad"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("texels", [128 * 128, 256 * 256, 512 * 256])
def test_gather_instances_equal_plain_on_card(texels):
    """Every instance that can hold the table (block, L2) and the wrapper's
    pick equal `gather_plain` bit for bit, 1M indices."""
    _need_card()
    table, _, idx = exp_gather.inputs((texels, 1), n=1 << 20)
    want = texfetch.gather_plain(table, idx).view(torch.int32)
    fits = [k for k in texfetch.INSTANCES
            if texfetch.slice_bytes(texels, k) <= texfetch.SLICE_BYTES]
    assert texfetch.instance_for(texels * 4) in fits
    for k in fits:
        got = texfetch._gather_instance(k, table, idx)
        assert torch.equal(got.view(torch.int32), want), texfetch.INSTANCES[k]
    assert torch.equal(texfetch.gather(table, idx).view(torch.int32), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1048577, "offset",
                               "out of range"])
def test_gather_edges_on_card(n):
    """Ragged counts, an index view at a 4-byte offset (scalar path) and
    indices outside the table (they read 0), on every instance at the
    256 KB and 512 KB sizes."""
    _need_card()
    for texels in (256 * 256, 512 * 256):
        table, _, idx = exp_gather.inputs((texels, 1), n=1 << 20, seed=3)
        if n == "offset":
            idx = idx[1:1 + 4099]
            assert idx.data_ptr() % 16 == 4
        elif n == "out of range":
            idx = idx[:4101].clone()
            bad = torch.tensor([-1, texels, 2 ** 31 - 1, -2 ** 31],
                               dtype=torch.int32, device="cuda")
            idx[::7] = bad.repeat(147)[:idx[::7].numel()]
        else:
            idx = idx[:n].contiguous() if n <= idx.numel() else \
                torch.randint(0, texels, (n,), dtype=torch.int32,
                              device="cuda")
        inside = (idx >= 0) & (idx < texels)
        want = torch.where(inside, texfetch.gather_plain(
            table, torch.where(inside, idx, 0)).view(torch.int32), 0)
        for k in texfetch.INSTANCES:
            if texfetch.slice_bytes(texels, k) > texfetch.SLICE_BYTES:
                continue
            got = texfetch._gather_instance(k, table, idx)
            torch.cuda.synchronize()
            assert got.shape == idx.shape
            assert torch.equal(got.view(torch.int32), want), \
                (texfetch.INSTANCES[k], texels)


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [64, 256])
def test_extract_cost_equals_plain_on_card(steps):
    """Each kind bit for bit with the plain version on the card."""
    _need_card()
    table, state = P2.inputs()
    for kind in P2.KINDS:
        assert torch.equal(P2.extract_cost(table, state, kind, steps),
                           P2.extract_cost_plain(table, state, kind, steps))


@pytest.mark.cuda
def test_extract_cost_full_loop_on_card():
    """At the probe's 4,096 steps each kind gives the first port's kernel's
    state, bit for bit (its SHA-256)."""
    _need_card()
    table, state = P2.inputs()
    for kind in P2.KINDS:
        got = P2.extract_cost(table, state, kind, P2.STEPS)
        assert P2.sha256(got) == P2.SHA256_STEPS[kind], kind


def _binary_inputs(n, dev):
    """The torus in the binary layout on `dev`, and n aimed rays of which
    some start inside its box and some are dead (t_bound -1, 0 and NaN)."""
    torus = PB.build_mesh_bundle([TORUS])
    pb = PPB.PackedMesh(*(t.to(dev) for t in PPB.pack_mesh(torus)))
    o, d = _aimed_rays(max(n, 1), 8, dev)
    o = tuple(torch.where(torch.arange(max(n, 1), device=dev) % 5 == 0,
                          0.3 * c, c)[:n] for c in o)
    d = tuple(c[:n] for c in d)
    tb = torch.full((n,), 1e30, device=dev)
    tb[::7], tb[3::11], tb[5::13] = -1.0, 0.0, float("nan")
    return pb, o, d, tb


@pytest.mark.cuda
@pytest.mark.parametrize("instance", ["packet", "grid stats"])
def test_k3_instances_equal_bitwise_on_card(instance):
    """K3 (the route's grid instance) against K4 (warp packets) and the
    grid instance asked for `stats` (which votes every step): t, normal,
    uv, tri and node visits bit for bit on the torus, dead lanes included,
    each launch counted under `k3_k4` and K4's under `k4` too, and all
    equal to the plain version; a dead lane keeps t = t_bound with one
    visit; `stats` counts busy <= total lane slots."""
    _need_card()
    dev = torch.device("cuda")
    pb, o, d, tb = _binary_inputs(4096, dev)
    before = launch_counts()
    stats = torch.zeros((2,), dtype=torch.int64, device=dev)
    route = PPB.traverse(o, d, pb, t_bound=tb, return_steps=True)
    other = PPB._launch("packet" if instance == "packet" else "grid", o, d,
                        pb, tb, True, stats)
    plain = PPB.traverse_binary_plain(o, d, pb, t_bound=tb)
    torch.cuda.synchronize()
    after = launch_counts()
    assert (after["k3_k4"], after["k4"]) == (
        before["k3_k4"] + 2, before["k4"] + (instance == "packet"))
    assert _same_bits(route, other) and _same_bits(route, plain)
    assert int((route[4] >= 0).sum()) > 1000
    dead = ~(tb > 0)
    assert torch.equal(route[0][dead].view(torch.int32),
                       tb[dead].view(torch.int32))
    assert (route[4][dead] == -1).all() and (route[5][dead] == 1).all()
    assert 0 < int(stats[0]) <= int(stats[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, 33, "all dead"])
def test_k3_k4_edge_counts_on_card(n):
    """Ray counts around a warp (0, 1, 31, 33) and a wavefront whose every
    lane is dead: every K3/K4 instance equals the plain version bit for
    bit."""
    _need_card()
    dev = torch.device("cuda")
    pb, o, d, tb = _binary_inputs(4096 if n == "all dead" else n, dev)
    if n == "all dead":
        tb = torch.full_like(tb, -1.0)
    plain = PPB.traverse_binary_plain(o, d, pb, t_bound=tb)
    for instance in PPB.INSTANCES:
        got = PPB._launch(instance, o, d, pb, tb, True)
        torch.cuda.synchronize()
        assert _same_bits(got, plain), instance
    if n == "all dead":
        assert (plain[5] == 1).all() and (plain[4] == -1).all()


@pytest.mark.cuda
def test_fused_rows_on_card():
    """The fused node rows on the card hold the two JAX-layout tables' box,
    skip and meta bit for bit."""
    _need_card()
    dev = torch.device("cuda")
    pb, _, _, _ = _binary_inputs(1, dev)
    assert torch.equal(pb.nodes[:, :6].view(torch.int32),
                       pb.nodes_f[:, :6].view(torch.int32))
    assert torch.equal(pb.nodes[:, 6:].contiguous().view(torch.int32),
                       pb.nodes_i[:, :2])


TORUS_NEE = """MATERIAL 0
RGB 1 1 1
EMITTANCE 6

MATERIAL 1
RGB .7 .6 .5

CAMERA
RES 64 64
FOVY 45
ITERATIONS 2
DEPTH 4
FILE torus_nee
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
mesh torus.obj
material 1
TRANS 0 1.5 0
ROTAT 30 0 0
SCALE 1.5 1.5 1.5

OBJECT 2
cube
material 1
TRANS 0 0 0
ROTAT 0 0 0
SCALE 10 .1 10
"""


@pytest.mark.cuda
def test_k2_any_hit_shadow_rays_match_plain_on_card(tmp_path):
    """One stratified NEE iteration of a torus scene (64x64, depth 4) on the
    card: the renderer's K2 any-hit launches (one a bounce but the last)
    are captured, and K2 in occlusion mode equals traverse8_plain(any_hit=
    True) on each of those wavefronts bit for bit, pops included."""
    _need_card()
    (tmp_path / "torus.obj").write_text(open(TORUS).read())
    path = tmp_path / "torus_nee.txt"
    path.write_text(TORUS_NEE)
    scene = load_scene(str(path))
    scene.settings.nee = True
    scene.settings.stratified = True
    r = Renderer(scene, device="cuda")
    assert r.route == "wavefront" and r.cfg.nee
    kernel, waves = P8.traverse8, []

    def capture(qo, qd, packed, t_bound=None, any_hit=False, **kwargs):
        if any_hit:
            waves.append((tuple(c.clone() for c in qo),
                           tuple(c.clone() for c in qd), t_bound.clone()))
        return kernel(qo, qd, packed, t_bound=t_bound, any_hit=any_hit,
                      **kwargs)
    before = launch_counts()["k2"]
    P8.traverse8 = capture
    try:
        r.step()
    finally:
        P8.traverse8 = kernel
    torch.cuda.synchronize()
    depth = scene.settings.trace_depth
    assert len(waves) == depth - 1
    assert launch_counts()["k2"] == before + depth + len(waves)
    packed = r.packed_meshes[0]
    for qo, qd, tb in waves:
        got = P8.traverse8(qo, qd, packed, t_bound=tb, any_hit=True,
                           return_pops=True)
        want = P8.traverse8_plain(qo, qd, packed, t_bound=tb, any_hit=True)
        torch.cuda.synchronize()
        assert _same_bits(got, want)
    assert int((waves[0][2] > 0).sum()) > 1000


def _render_marking_f3(r):
    """One iteration of `r`, and a [bounces, N] bool array marking, for
    each shadow pass, the live path slots whose shadow ray started inside a
    solid (it met a surface from within, less than 1e-3 from its origin).
    That is ROADMAP's F3: on cornell's 0.01-thick walls the 1e-4
    object-space back-off is about one float32 step of the distance, so a
    hit point lands on either side of its wall by an ulp of rounding, which
    the card and the CPU (their rsqrt, sin, cos) need not share."""
    from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
    real, flags = wf.intersect_planar, []

    def spy(*args, **kwargs):
        hit = real(*args, **kwargs)
        if kwargs.get("any_hit"):
            flags.append(((hit.t > 0) & (hit.t < 1e-3) & ~hit.outside
                          & kwargs["alive"]).cpu())
        return hit
    wf.intersect_planar = spy
    try:
        img = r.render(1)
    finally:
        wf.intersect_planar = real
    return img.reshape(-1, 3).T.cpu().numpy(), torch.stack(flags).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "lights"])
def test_nee_iteration_card_matches_cpu(name):
    """A stratified NEE iteration at 64x64 depth 8 on the card (the
    wavefront route) against the same iteration on the CPU, under the lane
    contract on the lanes where the two runs agree which shadow rays
    started inside a wall (`_render_marking_f3`); the others, at most 10%,
    are F3's."""
    _need_card()
    imgs, f3 = [], []
    for dev in ("cuda", "cpu"):
        scene = load_scene(os.path.join(SCENES, name + ".txt"))
        scene.camera.resolution = (64, 64)
        scene.camera.derive()
        scene.settings.trace_depth = 8
        scene.settings.stratified = True
        scene.settings.nee = True
        r = Renderer(scene, device=dev)
        assert r.route == "wavefront"
        img, flags = _render_marking_f3(r)
        imgs.append(img)
        f3.append(flags)
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0
    flips = (f3[0] != f3[1]).any(axis=0)
    assert flips.mean() <= 0.1
    assert_lane_contract(imgs[0][:, ~flips], imgs[1][:, ~flips])


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["shared", "fused"])
def test_texfetch_matches_plain_on_card(table):
    """ops/texfetch.take_u32 on the card is P1 (counted under `p1`), bit
    for bit with gather_plain: on a 64 KB table
    (the shared-memory instance) and on textured_env's 1.5 MB fused
    atlas+env table (the L2 instance), with 2048x2048 lanes; take_f32
    carries float bits; an int64 or strided index raises."""
    _need_card()
    rng = np.random.default_rng(21)
    if table == "shared":
        tab = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, 16384)
                               .astype(np.int32)).cuda()
    else:
        tx = texfetch.fuse(load_scene(os.path.join(
            SCENES, "textured_env.txt")).textures)
        tab = tx.fused_packed.cuda()
        assert tab.numel() == 512 * 512 + 512 * 256
    want_k = 1 if table == "shared" else 0
    assert texfetch.instance_for(tab.numel() * 4) == want_k
    idx = torch.from_numpy(rng.integers(0, tab.numel(), 2048 * 2048)
                           .astype(np.int32)).cuda()
    before = launch_counts()["p1"]
    got = texfetch.take_u32(tab, idx)
    torch.cuda.synchronize()
    assert launch_counts()["p1"] == before + 1
    assert torch.equal(got, texfetch.gather_plain(tab, idx))
    f = tab.view(torch.float32)
    assert torch.equal(texfetch.take_f32(f, idx).view(torch.int32),
                       texfetch.gather_plain(tab, idx))
    with pytest.raises(TypeError):
        texfetch.take_u32(tab, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        texfetch.take_u32(tab, idx[::2])


@pytest.mark.cuda
@pytest.mark.parametrize("name,flags", [
    ("textured_env", {}), ("textured_env", {"bilinear_fast": True}),
    ("textured_env", {"nee": True}), ("textured_env_proc", {})])
def test_textured_iteration_card_matches_cpu(name, flags):
    """A stratified iteration of a textured scene at 64x64 depth 8 on the
    card (the wavefront route: K2 on the torus, P1 on the texel fetches of
    textured_env) against the same iteration on the CPU, under the lane
    contract."""
    _need_card()
    imgs = []
    for dev in ("cuda", "cpu"):
        scene = load_scene(os.path.join(SCENES, name + ".txt"))
        scene.camera.resolution = (64, 64)
        scene.camera.derive()
        scene.settings.trace_depth = 8
        scene.settings.stratified = True
        for k, v in flags.items():
            setattr(scene.settings, k, v)
        scene.settings.bilinear = scene.settings.bilinear_fast
        r = Renderer(scene, device=dev)
        assert r.route == "wavefront"
        before = launch_counts()["p1"]
        imgs.append(r.render(1).reshape(-1, 3).T.cpu().numpy())
        if dev == "cuda":
            assert (launch_counts()["p1"] > before) == (
                name == "textured_env")
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0
    assert_lane_contract(imgs[0], imgs[1])


def _torus_room(tmp_path, res: int, **settings):
    """TORUS_NEE's room (the torus on a floor under a light) at res x res,
    depth 4, stratified, with RenderSettings fields `settings`."""
    (tmp_path / "torus.obj").write_text(open(TORUS).read())
    path = tmp_path / "torus_room.txt"
    path.write_text(TORUS_NEE)
    scene = load_scene(str(path))
    scene.camera.resolution = (res, res)
    scene.camera.derive()
    scene.settings.stratified = True
    for k, v in settings.items():
        setattr(scene.settings, k, v)
    return scene


@pytest.mark.cuda
def test_k2_on_compacted_wavefront_matches_plain_on_card(tmp_path):
    """One --sort --compact iteration of the torus room (128x128, depth 4)
    on the card: the renderer's K2 launches are captured; from bounce 1 on
    the wavefront is in bucket order (by the material of the last hit, then
    the misses), so bounce 1's dead lanes (t_bound -1) lie in at most one
    run a bucket; K2 equals traverse8_plain on each wavefront bit for bit,
    pops included."""
    _need_card()
    scene = _torus_room(tmp_path, 128, sort_materials=True, compact=True)
    r = Renderer(scene, device="cuda")
    assert r.route == "wavefront" and r.cfg.compact
    kernel, waves = P8.traverse8, []

    def capture(qo, qd, packed, t_bound=None, any_hit=False, **kwargs):
        waves.append((tuple(c.clone() for c in qo),
                       tuple(c.clone() for c in qd), t_bound.clone()))
        return kernel(qo, qd, packed, t_bound=t_bound, any_hit=any_hit,
                      **kwargs)
    before = launch_counts()["k2"]
    P8.traverse8 = capture
    try:
        r.step()
    finally:
        P8.traverse8 = kernel
    torch.cuda.synchronize()
    assert len(waves) == 4 and launch_counts()["k2"] == before + 4
    dead = ~(waves[1][2] > 0)
    runs = int(dead[0]) + int((dead[1:] & ~dead[:-1]).sum())
    assert 0 < int(dead.sum()) < dead.numel()
    assert 1 <= runs <= scene.num_materials + 2
    for qo, qd, tb in waves:
        got = P8.traverse8(qo, qd, r.packed_meshes[0], t_bound=tb,
                           return_pops=True)
        want = P8.traverse8_plain(qo, qd, r.packed_meshes[0], t_bound=tb)
        torch.cuda.synchronize()
        assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("stratified", [True, False])
def test_sorted_render_equals_unsorted_on_card(stratified, tmp_path):
    """The torus room at 128x128 depth 4, 2 iterations on the card: the
    --sort --compact image equals the identity order's bit for bit."""
    _need_card()
    imgs = []
    for knobs in ({}, {"sort_materials": True, "compact": True}):
        scene = _torus_room(tmp_path, 128, **knobs)
        scene.settings.stratified = stratified
        r = Renderer(scene, device="cuda")
        imgs.append(r.render(2).clone())
    assert float(imgs[0].mean()) > 0
    assert torch.equal(imgs[0], imgs[1])


def _adaptive(scene, epoch: int):
    scene.settings.adaptive = True
    scene.settings.adaptive_epoch = epoch
    scene.settings.stratified = True
    return scene


@pytest.mark.cuda
def test_k2_on_adaptive_wavefront_matches_plain_on_card(tmp_path):
    """The torus room at 128x128 depth 4 under --adaptive --adaptive-epoch
    4: after the replan at iteration 8 (the first whose counts spread) the
    mapping repeats pixels, each pixel's paths contiguous; the iteration's
    4 K2 launches are captured and K2 equals traverse8_plain on each of
    those wavefronts bit for bit, pops included."""
    _need_card()
    r = Renderer(_adaptive(_torus_room(tmp_path, 128), 4), device="cuda")
    assert r.route == "wavefront"
    r.render(8)
    kernel, waves = P8.traverse8, []

    def capture(qo, qd, packed, t_bound=None, any_hit=False, **kwargs):
        waves.append((tuple(c.clone() for c in qo),
                      tuple(c.clone() for c in qd), t_bound.clone()))
        return kernel(qo, qd, packed, t_bound=t_bound, any_hit=any_hit,
                      **kwargs)
    P8.traverse8 = capture
    try:
        r.step()
    finally:
        P8.traverse8 = kernel
    torch.cuda.synchronize()
    pix, _, count = r._plan
    assert int(count.max()) > 1 and bool((pix[1:] >= pix[:-1]).all())
    assert r.count.sum() == 9 * 128 * 128 and r.count.std() > 0
    assert len(waves) == 4
    for qo, qd, tb in waves:
        got = P8.traverse8(qo, qd, r.packed_meshes[0], t_bound=tb,
                           return_pops=True)
        want = P8.traverse8_plain(qo, qd, r.packed_meshes[0], t_bound=tb)
        torch.cuda.synchronize()
        assert _same_bits(got, want)


@pytest.mark.cuda
def test_adaptive_iteration_card_matches_cpu():
    """One stratified adaptive iteration of cornell at 64x64 depth 8 under a
    fixed non-uniform plan: the card against the CPU under the lane
    contract."""
    _need_card()
    from project3_cuda_path_tracer_tpu_torch.render import adaptive as A
    plan = A.plan_from_err(np.random.default_rng(5).gamma(
        0.5, 1.0, (64, 64)))
    imgs = []
    for dev in ("cuda", "cpu"):
        r = Renderer(_adaptive(_cornell(64), 32), device=dev)
        r._set_plan(plan)
        r.step()
        imgs.append(r.accum.reshape(-1, 3).T.cpu().numpy())
        assert r.route == "wavefront"
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0
    assert_lane_contract(imgs[0], imgs[1])


def _split(make, total, split):
    whole = make()
    whole.render(total)
    first = make()
    first.render(split)
    second = make()
    second.accum.copy_(first.accum)
    second.iteration = first.iteration
    second.restore_extras(first.checkpoint_extras())
    second.render(total - split)
    torch.cuda.synchronize()
    return whole, second


@pytest.mark.cuda
def test_adaptive_resume_on_card():
    """cornell 64x64 depth 4 --adaptive --adaptive-epoch 4: 12 iterations
    against 6 (mid-epoch), the extras, then 6 more: counts exactly, sums to
    2e-5 (the scatter sums a pixel's paths in a fixed order, so they agree
    bit for bit as well)."""
    _need_card()
    whole, resumed = _split(
        lambda: Renderer(_adaptive(_cornell(64), 4), device="cuda"), 12, 6)
    assert (whole.count == resumed.count).all() and whole.count.std() > 0
    for a, b in ((whole.accum, resumed.accum),
                 (whole.accum2, resumed.accum2)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)
    assert torch.equal(whole.accum, resumed.accum)


@pytest.mark.cuda
@pytest.mark.parametrize("settings", [{}, {"restir": 4}])
def test_resume_is_bitwise_on_card(settings):
    """A uniform render (K1) and a ReSTIR render (the wavefront, its
    reservoir through the extras) resumed at iteration 3 of 6 equal the
    uninterrupted render bit for bit."""
    _need_card()

    def make():
        scene = _cornell(64)
        for k, v in settings.items():
            setattr(scene.settings, k, v)
        return Renderer(scene, device="cuda")
    whole, resumed = _split(make, 6, 3)
    assert whole.route == ("wavefront" if settings else "megakernel")
    assert torch.equal(whole.accum, resumed.accum)


def _textured(res: int):
    scene = load_scene(os.path.join(SCENES, "textured_env.txt"))
    scene.camera.resolution = (res, res)
    scene.camera.derive()
    scene.settings.trace_depth = 4
    return scene


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["torus_k2", "textured_p1", "torus_nee_k2",
                                  "torus_binary_k3", "sharded_adaptive"])
def test_graph_replay_equals_eager_loop_on_card(case, tmp_path):
    """step_many(n) on the wavefront route (one eager iteration, a capture,
    n - 1 replays) against n eager step() calls: the state bit for bit
    (`same_state`); the kernels' device tallies count the eager launches
    and each replay's; the graph holds the kernels: K2 on the torus room (4
    launches a replay at depth 4), with NEE its any-hit shadow rays too, K3
    on the room's binary tree, P1 on textured_env's texel fetches; the
    sharded renderer (a world of one) across adaptive replans."""
    _need_card()
    import dataclasses

    from project3_cuda_path_tracer_tpu_torch.parallel import sharding
    n = 8 if case == "sharded_adaptive" else 5

    def make():
        if case == "torus_k2":
            return Renderer(_torus_room(tmp_path, 64), device="cuda")
        if case == "torus_nee_k2":
            return Renderer(_torus_room(tmp_path, 64, nee=True),
                            device="cuda")
        if case == "torus_binary_k3":
            scene = _torus_room(tmp_path, 64)
            return Renderer(dataclasses.replace(
                scene, packed_meshes=PPB.pack_all(scene.meshes)),
                device="cuda")
        if case == "sharded_adaptive":
            scene = _cornell(64)
            scene.settings.trace_depth = 4
            scene.settings.adaptive = scene.settings.stratified = True
            scene.settings.adaptive_epoch = 3
            return sharding.ShardedRenderer(scene, device="cuda")
        return Renderer(_textured(64), device="cuda")
    if case == "sharded_adaptive":
        sharding.init_distributed("nccl")
    try:
        eager, chunk = make(), make()
        assert chunk.route == "wavefront" and chunk.chunkable()
        replans, replan = [], chunk._replan

        def counted():
            replans.append(chunk.iteration)
            replan()
        chunk._replan = counted
        for _ in range(n):
            eager.step()
        launches.zero_launch_counts()
        chunk.step_many(n)
        torch.cuda.synchronize()
    finally:
        sharding.shutdown()
    assert same_state(eager, chunk)
    g = chunk.graph
    assert g is not None and g.replays == n - 1 and g.pool_bytes > 0
    # what ran, by the kernels' own tallies: the eager iteration's
    # launches and each replay's
    assert launches.device_launches() == {
        k: n * g.launches[k] for k in launches.TALLY_SLOTS}
    want = {"torus_k2": dict(k2=4, k2_any_hit=0, k3_k4=0, p1=0),
            "torus_nee_k2": dict(k3_k4=0, p1=0),
            "torus_binary_k3": dict(k2=0, k3_k4=4, p1=0),
            "textured_p1": dict(k2=4, k3_k4=0),
            "sharded_adaptive": dict(k2=0, k3_k4=0, p1=0)}[case]
    assert {k: g.launches[k] for k in want} == want
    assert g.launches["mat_grad"] == 0  # a render takes no gradient
    if case == "textured_p1":
        assert g.launches["p1"] > 0
    if case == "torus_nee_k2":
        assert g.launches["k2"] > 4 and g.launches["k2_any_hit"] > 0
    if case == "sharded_adaptive":
        assert replans == [3, 6]  # both between replays


@pytest.mark.cuda
@pytest.mark.parametrize("settings", [
    {"restir": 4}, {"adaptive": True, "adaptive_epoch": 3,
                    "stratified": True}])
def test_replay_after_reset_and_restore_on_card(settings):
    """A captured graph replays on after reset() (an orbit: the camera
    tensors and buffers are overwritten in place), giving a fresh
    Renderer's frame at the new camera, and after restore_extras (a
    resume), giving the uninterrupted render, both bit for bit."""
    _need_card()

    def make():
        scene = _cornell(64)
        scene.settings.trace_depth = 4
        for k, v in settings.items():
            setattr(scene.settings, k, v)
        return Renderer(scene, device="cuda", route="wavefront")
    r = make()
    r.step_many(4)
    g = r.graph
    assert g is not None
    r.scene.camera.position = r.scene.camera.position + np.float32(0.3)
    r.scene.camera.derive()
    r.reset()
    r.step_many(7)
    fresh = Renderer(r.scene, device="cuda", route="wavefront")
    for _ in range(7):
        fresh.step()
    torch.cuda.synchronize()
    assert r.graph is g and g.replays == 3 + 7
    assert same_state(r, fresh)

    whole, half, resumed = make(), make(), make()
    whole.step_many(8)
    half.step_many(4)
    resumed.step_many(3)  # captured before the restore
    g = resumed.graph
    resumed.reset()
    resumed.accum.copy_(half.accum)
    resumed.iteration = half.iteration
    resumed.restore_extras(half.checkpoint_extras())
    resumed.step_many(4)
    torch.cuda.synchronize()
    assert resumed.graph is g
    assert same_state(whole, resumed)


@pytest.mark.cuda
def test_failing_capture_raises_on_card(monkeypatch):
    """A capture that fails raises, from the capture helper and through
    step_many, and nothing falls back to the loop of steps."""
    _need_card()
    from project3_cuda_path_tracer_tpu_torch.render import integrator as I
    from project3_cuda_path_tracer_tpu_torch.utils.device import \
        capture_graph
    x = torch.ones(8, device="cuda")
    with pytest.raises(RuntimeError):
        capture_graph(lambda: x.sum().item(), torch.device("cuda"))
    r = Renderer(_cornell(32), device="cuda", route="wavefront")
    to_image = I.to_image

    def reads_on_host(rad, cfg):
        float(rad.x.sum())  # a host read: legal eagerly, not in a capture
        return to_image(rad, cfg)
    monkeypatch.setattr(I, "to_image", reads_on_host)
    with pytest.raises(RuntimeError):
        r.step_many(3)
    assert r.graph is None and r.iteration == 1
    monkeypatch.setattr(I, "to_image", to_image)
    assert float(x.sum()) == 8.0  # the context survives the failed capture


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cornell_history", "cornell_two_render",
                                  "textured_history"])
def test_train_scan_replays_equal_eager_loop_on_card(case):
    """make_train_scan on the card (one eager step, the capture, replays;
    a second call replays the same graph) against the loop of
    make_train_step calls, at 64x64 depth 4, by chip_smoke.py's rule: one
    eager step run twice from one state sets the spread (0 when the two
    agree bit for bit, which then the graph must too); the graph's state
    (losses, leaves, mu, nu, count, history) is within it. On textured_env
    (remat by the rule) K2 and P1 run inside the graph: the kernels' device
    tallies equal the eager step's launches plus the capture's count a
    replay."""
    _need_card()
    from project3_cuda_path_tracer_tpu_torch.models import inverse as inv
    from project3_cuda_path_tracer_tpu_torch.models import optim
    from project3_cuda_path_tracer_tpu_torch.render import integrator as I
    history = case.endswith("history")
    scene = _textured(64) if case.startswith("textured") else _cornell(64)
    scene.settings.trace_depth = 4
    dev = torch.device("cuda")
    cfg = inv.train_config(scene)
    assert cfg.remat == case.startswith("textured")
    tables = (I.to_device(scene.geoms, dev), I.to_device(scene.meshes, dev),
              texfetch.fuse(I.to_device(scene.textures, dev)))
    packed = tuple(I.to_device(p, dev) for p in scene.packed_meshes)
    rng = np.random.default_rng(0)
    target = torch.from_numpy(rng.random((64, 64, 3), np.float32) * .5).to(
        dev)
    hist0 = torch.from_numpy(rng.random((64, 64, 3), np.float32)).to(dev)
    step = inv.make_train_step(*tables, cfg, packed_meshes=packed,
                               history=history)

    def start():
        p = inv.params_from_scene(scene, dev)
        return p, optim.init(inv.param_leaves(p)), hist0.clone()

    def eager(state, seed, n):
        p, s, h = state
        losses = []
        for i in range(n):
            gen = inv.step_generator(seed, i, dev)
            if history:
                p, s, h, loss = step(p, s, h, gen, target)
            else:
                p, s, loss = step(p, s, gen, target)
            losses.append(loss)
        return p, s, h if history else None, torch.stack(losses)

    spread = inv.train_state_gap(eager(start(), 7, 1), eager(start(), 7, 1))
    if case.startswith("cornell"):
        # G1 sums in a fixed order: two eager steps agree bit for bit, so
        # the graph is held to 0 below
        assert not any(spread.values()), spread
    run = inv.make_train_scan(*tables, cfg, num_steps=3,
                              packed_meshes=packed, history=history)
    want = eager(start(), 7, 3)
    launches.zero_launch_counts()
    p, s, h = start()
    got = run(p, s, h, 7, target) if history else run(p, s, 7, target)
    torch.cuda.synchronize()
    ran, wrappers = launches.device_launches(), launches.launch_counts()
    got = got if history else (got[0], got[1], None, got[2])
    gap = inv.train_state_gap(got, want)
    assert all(gap[k] <= spread[k] for k in gap), (gap, spread)
    g = run.train_graph.graph
    assert g is not None and g.replays == 2 and g.pool_bytes > 0
    # the eager step's wrapper counts and the capture's are one step's
    assert {k: ran[k] for k in ("k2", "p1", "mat_grad")} == {
        k: wrappers[k] // 2 + 2 * g.launches[k]
        for k in ("k2", "p1", "mat_grad")}
    # one G1 call a backward of a material field read, in each step
    assert wrappers["mat_grad"] == 2 * g.launches["mat_grad"] > 0
    if case.startswith("textured"):
        assert g.launches["k2"] == g.launches["p1"] == 8  # 4 bounces, remat
    # the next call: replays alone, from fresh tensors
    want2 = eager(inv.copy_train_state(*want[:3]), 8, 3)
    nxt = inv.copy_train_state(*got[:3])
    got2 = (run(*nxt, 8, target) if history
            else run(nxt[0], nxt[1], 8, target))
    got2 = got2 if history else (got2[0], got2[1], None, got2[2])
    gap2 = inv.train_state_gap(got2, want2)
    assert all(gap2[k] <= spread[k] for k in gap2), (gap2, spread)
    assert run.train_graph.graph is g and g.replays == 5

