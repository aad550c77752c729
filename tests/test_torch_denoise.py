"""The à-trous denoiser and its G-buffer in the torch port
(render/denoise.py, render/denoise_gbuf.py) against the JAX package.

The filter is the same arithmetic in the same order in both packages (JAX's
an XLA program, the port's torch ops), so the plain, the demodulated and the
variance-guided filter agree to rtol 1e-5. The G-buffer is a first-hit
query of the deterministic camera rays: cornell with the mirror relay on
and off, scenes/mesh.txt and the textured scenes/textured_env.txt (the
albedo's atlas texels) under the lane contract of
tests/test_torch_megakernel.py (lanes to 1e-4, at most 1% diverge). The
scenes have no aperture or shutter: on such a scene the JAX G-buffer draws
its lens and time samples from PRNGKey(0) and the port from a torch
generator, and the two cannot agree lane for lane. Then the JAX
tests/test_denoise.py claims through the port's Renderer: denoised 4 spp
lands closer to a many-spp reference than raw 4 spp, and the CLI's
--denoise writes a PNG.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.render import denoise as JD
from project3_cuda_path_tracer_tpu.render import integrator as JI
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.app import cli
from project3_cuda_path_tracer_tpu_torch.render import denoise as PD
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from test_torch_megakernel import assert_lane_contract
from test_torch_mesh import _port_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
CORNELL = os.path.join(SCENES, "cornell.txt")


def _sized(scene, res, depth=None):
    cam = dataclasses.replace(scene.camera, resolution=(res, res)).derive()
    st = dataclasses.replace(scene.settings)
    if depth is not None:
        st.trace_depth = depth
    return dataclasses.replace(scene, camera=cam, settings=st)


def _inputs(seed, h=24, w=20):
    """A noisy image over two planes with different normals, a smooth
    position ramp, a checker albedo: numpy float32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (0.2 + 0.6 * (xx >= w // 2))[..., None] + rng.normal(
        0, 0.15, (h, w, 3))
    normal = np.zeros((h, w, 3))
    normal[:, : w // 2, 1] = 1.0
    normal[:, w // 2:, 0] = 1.0
    pos = np.stack([xx * 0.02, rng.normal(0, 0.01, (h, w)), yy * 0.02], -1)
    alb = np.where(((yy // 2 + xx // 2) % 2)[..., None] > 0, 0.9, 0.2) \
        * np.ones((1, 1, 3))
    return tuple(np.abs(a).astype(np.float32) if i == 0 else
                 a.astype(np.float32)
                 for i, a in enumerate((img, normal, pos, alb)))


@pytest.mark.parametrize("dy,dx", [(1, 0), (0, -2), (-3, 4), (8, 8)])
def test_shift_matches_jax(dy, dx):
    a = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        PD._shift(torch.from_numpy(a), dy, dx).numpy(),
        np.asarray(JD._shift(jnp.asarray(a), dy, dx)))


def test_lum_and_gauss3_match_jax():
    a = np.random.default_rng(1).random((9, 11, 3)).astype(np.float32)
    np.testing.assert_array_equal(PD._lum(torch.from_numpy(a)).numpy(),
                                  np.asarray(JD._lum(jnp.asarray(a))))
    np.testing.assert_allclose(PD._gauss3(torch.from_numpy(a)).numpy(),
                               np.asarray(JD._gauss3(jnp.asarray(a))),
                               rtol=1e-6)


@pytest.mark.parametrize("mode", ["plain", "demodulated",
                                  "variance_guided"])
def test_atrous_denoise_matches_jax(mode):
    img, normal, pos, alb = _inputs(2)
    kw = {"plain": {}, "demodulated": {"albedo": alb},
          "variance_guided": {"albedo": alb, "variance_guided": True}}[mode]
    got = PD.atrous_denoise(
        torch.from_numpy(img), torch.from_numpy(normal),
        torch.from_numpy(pos),
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}).numpy()
    want = np.asarray(JD.atrous_denoise(
        jnp.asarray(img), jnp.asarray(normal), jnp.asarray(pos),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}))
    assert got.shape == img.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # the filter smooths the illumination (the albedo is remodulated)
    demod = np.maximum(kw.get("albedo", 1.0), 1e-2)
    assert np.abs(np.diff(got / demod, axis=0)).mean() < \
        0.5 * np.abs(np.diff(img / demod, axis=0)).mean()


def test_demod_identity_when_albedo_one():
    img, normal, pos, _ = (torch.from_numpy(a) for a in _inputs(3))
    a = PD.atrous_denoise(img, normal, pos)
    b = PD.atrous_denoise(img, normal, pos, albedo=torch.ones_like(img))
    assert torch.equal(a, b)


def _gbuffers(js, ps, **kw):
    """Port and JAX (normal, pos, albedo) at the scenes' size, as [3, N]
    planes each."""
    jcfg = JI.build_trace_config(js, js.settings)
    pcfg = PI.build_trace_config(ps, ps.settings)
    want = JD.gbuffer(js, jcfg, js.packed_meshes, albedo=True, **kw)
    got = PD.gbuffer(ps, pcfg, ps.packed_meshes, albedo=True, **kw)
    n = pcfg.width * pcfg.height
    return ([g.numpy().reshape(n, 3).T for g in got],
            [np.asarray(w).reshape(n, 3).T for w in want])


def _assert_gbuffers(got, want):
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        assert_lane_contract(g, w)


@pytest.mark.parametrize("relay", [True, False])
def test_gbuffer_matches_jax_cornell(relay):
    js = _sized(jax_load_scene(CORNELL), 32)
    ps = _sized(load_scene(CORNELL), 32)
    got, want = _gbuffers(js, ps, relay=relay)
    _assert_gbuffers(got, want)
    alb = got[2].T.reshape(32, 32, 3)
    if relay:
        # the centre pixel sees the mirror sphere head-on: the relayed ray
        # lands on the diffuse-white back wall -> .98 (spec) x .98
        assert np.allclose(alb[16, 16], 0.98 * 0.98, atol=1e-3)
    else:
        assert np.allclose(alb[16, 16], 1.0)


@pytest.fixture(scope="module")
def blob():
    js = jax_load_scene(os.path.join(SCENES, "mesh.txt"))
    return js, _port_scene(js)


def test_gbuffer_matches_jax_mesh(blob):
    js, ps = (_sized(s, 32) for s in blob)
    got, want = _gbuffers(js, ps)
    _assert_gbuffers(got, want)
    # miss conventions: normal 0, position 1e6, albedo 1
    miss = got[1][0] == 1e6
    assert miss.any() and (got[0][:, miss] == 0).all() \
        and (got[2][:, miss] == 1).all()


def test_gbuffer_matches_jax_textured():
    """textured_env.txt has an aperture: the G-buffer is held on its
    pinhole twin (aperture 0), where both packages trace the same rays."""
    path = os.path.join(SCENES, "textured_env.txt")
    js, ps = _sized(jax_load_scene(path), 32), _sized(load_scene(path), 32)
    js, ps = (dataclasses.replace(s, camera=dataclasses.replace(
        s.camera, aperture=0.0).derive()) for s in (js, ps))
    got, want = _gbuffers(js, ps)
    _assert_gbuffers(got, want)
    # the atlas shows: some lanes carry a texel colour, no material's
    flat = ps.materials.color.numpy()
    texel = ~(np.abs(got[2].T[:, None, :] - flat[None]) < 1e-4).all(
        axis=2).any(axis=1) & (got[2] < 1).any(axis=0)
    assert texel.sum() > 16


def _cornell_small(res=64, depth=4):
    return _sized(load_scene(CORNELL), res, depth)


def test_renderer_denoise_improves_low_spp(tmp_path):
    """4-spp cornell denoised lands closer to a 160-spp reference than raw
    4 spp: the JAX test_renderer_denoise_improves_low_spp claim at its
    size, seeds and bound."""
    ref = Renderer(_cornell_small(), device="cpu")
    ref.render(160, seed=3)
    truth = ref.image()
    low = Renderer(_cornell_small(), device="cpu")
    low.render(4, seed=7)
    raw = low.image()
    den = low.denoised_accum().numpy()[:, ::-1, :] / 4
    rmse_raw = float(np.sqrt(((raw - truth) ** 2).mean()))
    rmse_den = float(np.sqrt(((den - truth) ** 2).mean()))
    assert rmse_den < 0.6 * rmse_raw, (rmse_den, rmse_raw)
    out = low.save(str(tmp_path / "dn"), denoise=True)
    assert out.endswith(".png") and os.path.getsize(out) > 0


def test_denoised_accum_adaptive_divides_by_count():
    """Under adaptive sampling the filter sees accum / count."""
    s = _cornell_small(16, 3)
    s.settings.adaptive = True
    s.settings.stratified = True
    s.settings.adaptive_epoch = 2
    r = Renderer(s, device="cpu")
    r.render(5)
    normal, pos, alb = PD.gbuffer(r.scene, r.cfg, albedo=True, relay=False,
                                  tables=r.tables)
    mean = r.accum / torch.clamp(torch.from_numpy(r.count), min=1.0)[..., None]
    want = PD.atrous_denoise(mean, normal, pos, albedo=alb) * 5
    assert torch.equal(r.denoised_accum(), want)


def test_cli_denoise(tmp_path, capsys):
    with open(CORNELL) as f:
        text = f.read().replace("RES         800 800", "RES         24 24")
    scene = tmp_path / "c24.txt"
    scene.write_text(text)
    rc = cli.main([str(scene), "--device", "cpu", "--iterations", "2",
                   "--depth", "2", "--denoise", "--outdir", str(tmp_path)])
    assert rc == 0
    assert (tmp_path / "cornell.png").read_bytes()[:4] == b"\x89PNG"
