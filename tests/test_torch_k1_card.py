"""K1 (csrc/megakernel.cu) against its plain version at the main path's size,
on a card: bit for bit, and its live-segment tally.

The kernel rounds every operation as the torch chain of `iteration_plain`
does, so at 800x800 depth 8 on cornell and cornell_glass (whose glass
sphere takes the refractive lobe) the accumulators are equal, on injected
uniforms and on the stratified lattice. The device tally's `k1_segments`
slot counts the live segments a launch traced: the lanes alive on entering
each bounce of the plain chain (`k1_slots` beside it, the lane slots). Every test is `cuda`-marked and skips
without a card; the file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_k1_card.py --noconftest -m cuda
"""
import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
from project3_cuda_path_tracer_tpu_torch.render.integrator import \
    build_trace_config
from project3_cuda_path_tracer_tpu_torch.utils import launches

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
RES = 800


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(name, sampler, seed=3):
    """The scene's packed table and config on the card, and for "uniforms"
    seeded camera and bounce uniforms."""
    scene = load_scene(os.path.join(SCENES, name + ".txt"))
    assert scene.camera.resolution == (RES, RES)
    cfg = build_trace_config(scene)
    dev = torch.device("cuda")
    cam_u = u = None
    if sampler == "uniforms":
        rng = np.random.default_rng(seed)
        n = RES * RES
        cam_u = torch.from_numpy(rng.random((mk.CAM_DIMS, n),
                                            dtype=np.float32)).to(dev)
        u = torch.from_numpy(rng.random((cfg.trace_depth, 4, n),
                                        dtype=np.float32)).to(dev)
    return mk.pack_scene(scene, dev), cfg, cam_u, u


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "cornell_glass"])
@pytest.mark.parametrize("sampler", ["uniforms", "stratified"])
def test_kernel_equals_plain_at_800(name, sampler):
    _need_card()
    table, cfg, cam_u, u = _inputs(name, sampler)
    dev = table.device
    zeros = torch.zeros((RES, RES, 3), device=dev)
    for it in (0, 7):
        got = mk.iteration(zeros.clone(), table, cfg, it, 11, sampler, cam_u,
                           u)
        want = mk.iteration_plain(zeros.clone(), table, cfg, it, 11, sampler,
                                  cam_u, u)
        torch.cuda.synchronize()
        differ = int((got != want).any(-1).sum())
        assert differ == 0, f"{differ} pixels differ at iteration {it}"
        assert float(got.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "cornell_glass"])
def test_segments_tally_counts_the_plain_live_lanes(monkeypatch, name):
    """The tally's increase over one launch is the sum over bounces of the
    plain chain's lanes alive on entering each bounce's shading step."""
    _need_card()
    table, cfg, _, _ = _inputs(name, "stratified")
    dev = table.device
    live = []
    shade = wf.shade_planar

    def counted(hit, ray_d, throughput, alive, *args, **kwargs):
        live.append(int(alive.sum()))
        return shade(hit, ray_d, throughput, alive, *args, **kwargs)

    monkeypatch.setattr(wf, "shade_planar", counted)
    mk.iteration_plain(torch.zeros((RES, RES, 3), device=dev), table, cfg,
                       5, 0, "stratified")
    assert len(live) == cfg.trace_depth
    start = launches.device_launches()
    before = start["k1_segments"]
    mk.iteration(torch.zeros((RES, RES, 3), device=dev), table, cfg, 5, 0,
                 "stratified")
    torch.cuda.synchronize()
    now = launches.device_launches()
    got = now["k1_segments"] - before
    assert got == sum(live) > RES * RES
    # beside them the lane slots its warps stepped, 32 a warp's bounce
    slots = now["k1_slots"] - start["k1_slots"]
    assert slots % 32 == 0 and slots >= got
    # the grid schedule traces the same segments
    mk._iteration_grid(torch.zeros((RES, RES, 3), device=dev), table, cfg,
                       5, 0, "stratified")
    torch.cuda.synchronize()
    assert launches.device_launches()["k1_segments"] - before == 2 * got


@pytest.mark.cuda
def test_renderer_steps_add_their_segments():
    """The renderer's megakernel route counts each step's segments: two
    steps of cornell_glass add two launches' worth."""
    _need_card()
    scene = load_scene(os.path.join(SCENES, "cornell_glass.txt"))
    scene.camera.resolution = (64, 64)
    scene.camera.derive()
    scene.settings.stratified = True
    r = Renderer(scene, device="cuda")
    assert r.route == "megakernel"
    launches.zero_launch_counts()
    r.step_many(2)
    torch.cuda.synchronize()
    segs = launches.device_launches()["k1_segments"]
    assert launches.launch_counts()["k1"] == 2
    assert 2 * 64 * 64 <= segs <= 2 * 64 * 64 * r.cfg.trace_depth
