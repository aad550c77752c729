"""Env-map and mixed NEE of the torch port (slice D) against the JAX
package.

Tolerances: the alias table (`build_env_alias`: alias, prob and C) bit for
bit; `sample_env_planar` on injected uniforms to 1e-6 (directions and
radiance); `shade_planar`'s env-miss MIS weight and whole stratified
iterations under the lane contract of tests/test_torch_megakernel.py
(lanes to 1e-4, at most 1% diverge, means within 0.05). Env-only NEE runs
on scenes/textured_env.txt (no emitter: the NEE mode its users get), the
mixed mode on a copy with one emissive sphere added (its whole
iterations, plain and RIS, are in tests/test_torch_envnee_render.py). No
shadow ray starts inside a thin wall in these scenes (ROADMAP F3 concerns
cornell's 0.01-scaled walls), so the lanes are held against the jitted JAX
evaluation alone.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.ops import nee as jnee
from project3_cuda_path_tracer_tpu.ops import wavefront as jwf
from project3_cuda_path_tracer_tpu.ops.vec import V3 as JV3
from project3_cuda_path_tracer_tpu.render import integrator as JI
from project3_cuda_path_tracer_tpu.utils import image as jimg
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.ops import nee as pnee
from project3_cuda_path_tracer_tpu_torch.ops import texfetch
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
from project3_cuda_path_tracer_tpu_torch.ops.vec import V3
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from test_torch_megakernel import assert_lane_contract
from test_torch_textures import _hit_to_port, _scene_rays, to_port

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
RES, DEPTH, M = 32, 4, 4
EMITTER = """
MATERIAL 4
RGB 1 .9 .8
EMITTANCE 6

OBJECT 4
sphere
material 4
TRANS 1.5 4 3
ROTAT 0 0 0
SCALE 1 1 1
"""


def mixed_scene_path(tmp_path) -> str:
    """textured_env with one emissive sphere added (the assets by their
    absolute paths)."""
    with open(os.path.join(SCENES, "textured_env.txt")) as f:
        text = f.read()
    text = (text.replace("assets/", os.path.join(SCENES, "assets") + "/")
            .replace("meshes/", os.path.join(SCENES, "meshes") + "/"))
    path = tmp_path / "textured_env_lit.txt"
    path.write_text(text + EMITTER)
    return str(path)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """name -> (JAX scene, port scene) for "env" (textured_env) and
    "mixed" (its copy with an emitter), each parsed once."""
    tmp = tmp_path_factory.mktemp("envnee")
    env = os.path.join(SCENES, "textured_env.txt")
    mixed = mixed_scene_path(tmp)
    return {"env": (jax_load_scene(env), load_scene(env)),
            "mixed": (jax_load_scene(mixed), load_scene(mixed))}


def sized(scene, **settings):
    cam = dataclasses.replace(scene.camera, resolution=(RES, RES)).derive()
    st = dataclasses.replace(scene.settings, trace_depth=DEPTH,
                             stratified=True, **settings)
    return dataclasses.replace(scene, camera=cam, settings=st)


def wired(js, ps):
    """The JAX and port TraceConfigs with NEE wired (`_wire_nee`)."""
    return (JI._wire_nee(js, JI.build_trace_config(js, js.settings)),
            PI._wire_nee(ps, PI.build_trace_config(ps)))


@pytest.mark.parametrize("env", ["sky.hdr", "random"])
def test_build_env_alias_matches_jax(env):
    """Vose's table over luminance x solid angle: alias, prob and C bit for
    bit; a black env has none."""
    if env == "sky.hdr":
        img = jimg.read_hdr(os.path.join(SCENES, "assets", "sky.hdr"))
    else:
        rng = np.random.default_rng(3)
        img = (rng.uniform(0, 1, (16, 32, 3)) ** 4 * 30).astype(np.float32)
    got, want = pnee.build_env_alias(img), jnee.build_env_alias(img)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
    assert pnee.build_env_alias(np.zeros((4, 8, 3), np.float32)) is None
    assert pnee.build_env_alias(np.ones((1, 1, 3), np.float32)) is None


def test_sample_env_matches_jax(scenes):
    """sample_env_planar on the same uniforms (the alias table's two
    fetches and the RGBE texel's through ops/texfetch): directions and
    radiance to 1e-6; env_lum to 1e-6 of the JAX plane."""
    js, ps = scenes["env"]
    jcfg, pcfg = wired(js, ps)
    n = 8192
    u = np.random.default_rng(9).random((4, n), dtype=np.float32)
    u[:, :3] = [[0.0, 1 - 1e-7, 0.5], [0.0, 0.999, 1.0],
                [0.0, 0.5, 1 - 1e-7], [0.0, 1 - 1e-7, 0.5]]
    ptx = texfetch.fuse(ps.textures)
    wl, le = pnee.sample_env_planar(ptx, *(torch.from_numpy(c) for c in u))
    jwl, jle = jnee.sample_env_planar(js.textures,
                                      *(jnp.asarray(c) for c in u))
    for g, w in zip((*wl, *le), (*jwl, *jle)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)
    np.testing.assert_allclose(pnee.env_lum(le).numpy(),
                               np.asarray(jnee.env_lum(jle)), rtol=1e-6)
    assert float(le.x.max()) > 0


@pytest.mark.parametrize("name", ["env", "mixed"])
def test_wire_nee_modes(name, scenes):
    """`_wire_nee`: textured_env gets env-only NEE (nee_q 0), the copy with
    an emitter the mixed mode with the JAX package's flux split, both with
    the JAX env constant C and alias table; ReSTIR on an env scene is
    dropped."""
    js, ps = (sized(s) for s in scenes[name])
    jcfg, pcfg = wired(js, ps)
    for k in ("nee", "nee_env", "nee_env_c", "nee_q", "nee_lights",
              "nee_area"):
        assert getattr(pcfg, k) == getattr(jcfg, k), k
    assert pcfg.nee and pcfg.nee_env
    assert (pcfg.nee_q == 0.0) == (name == "env")
    np.testing.assert_array_equal(ps.textures.env_alias.numpy(),
                                  np.asarray(js.textures.env_alias))
    np.testing.assert_array_equal(ps.textures.env_prob.numpy(),
                                  np.asarray(js.textures.env_prob))
    ps.settings.restir = 2
    r = Renderer(ps, device="cpu")
    assert r.cfg.nee and not r.cfg.restir and r.reservoir is None
    assert any(d.startswith("restir") for d in r.drops)


def test_procedural_sky_drops_env_nee(tmp_path):
    """The sky has no sampling table: --nee on textured_env_proc (no
    emitter, no env map) is a drop, as in the JAX package."""
    path = os.path.join(SCENES, "textured_env_proc.txt")
    js, ps = jax_load_scene(path), load_scene(path)
    jcfg, pcfg = wired(js, ps)
    assert not jcfg.nee and not pcfg.nee


def test_shade_env_mis_matches_jax(scenes):
    """shade_planar with an injected NEE tuple in the env and mixed modes:
    the env miss weighted by prev_pdf / (prev_pdf + lum(env) * C (1 - q)),
    the emissive hit by the area weight scaled by q, the direct term, under
    the lane contract."""
    js, ps = scenes["mixed"]
    jcfg, pcfg = wired(js, ps)
    n = 4096
    o, d = _scene_rays(n, 12)
    jd = JV3(*(jnp.asarray(c) for c in d))
    gt = tuple(int(t) for t in np.asarray(js.geoms.type))
    mids = tuple(int(t) for t in np.asarray(js.geoms.mesh_id))
    jh = jwf.intersect_planar(JV3(*(jnp.asarray(c) for c in o)), jd,
                              jnp.zeros(n), js.geoms, js.meshes, gt,
                              js.packed_meshes, mids)
    rng = np.random.default_rng(13)
    thr = rng.uniform(0.1, 1.0, (3, n)).astype(np.float32)
    alive = rng.random(n) < 0.9
    last = rng.random(n) < 0.1
    u = rng.random((4, n), dtype=np.float32)
    wl = rng.normal(size=(3, n))
    wl = (wl / np.linalg.norm(wl, axis=0)).astype(np.float32)
    vis = rng.random(n) < 0.7
    le = rng.uniform(0.0, 20.0, (3, n)).astype(np.float32)
    pdf_l = rng.uniform(0.01, 5.0, n).astype(np.float32)
    prev = np.where(rng.random(n) < 0.25, 0.0,
                    rng.uniform(0.01, 1.0, n)).astype(np.float32)
    t = torch.from_numpy
    for q_mode in ("env", "mixed"):
        kw = dict(nee_area=jcfg.nee_area if q_mode == "mixed" else 0.0,
                  nee_env_c=jcfg.nee_env_c,
                  nee_q=jcfg.nee_q if q_mode == "mixed" else 0.0)
        jout = jwf.shade_planar(
            jh, jd, JV3(*(jnp.asarray(c) for c in thr)), jnp.asarray(alive),
            js.materials, js.textures, jnp.asarray(u),
            last_bounce=jnp.asarray(last), glossy=False, sky=False,
            nee=(JV3(*(jnp.asarray(c) for c in wl)), jnp.asarray(vis),
                 JV3(*(jnp.asarray(c) for c in le)), jnp.asarray(pdf_l),
                 jnp.asarray(prev)), **kw)
        pout = wf.shade_planar(
            _hit_to_port(jh), V3(*(t(c) for c in d)),
            V3(*(t(c) for c in thr)), t(alive), ps.materials,
            to_port(js.textures), t(u), last_bounce=t(last), glossy=False,
            nee=(V3(*(t(c) for c in wl)), t(vis), V3(*(t(c) for c in le)),
                 t(pdf_l), t(prev)), **kw)
        for k in ("origin", "direction", "throughput", "radiance"):
            assert_lane_contract(
                np.stack([c.numpy() for c in getattr(pout, k)]),
                np.stack([np.asarray(c) for c in getattr(jout, k)]))
        assert_lane_contract(pout.nee_pdf.numpy()[None],
                             np.asarray(jout.nee_pdf)[None])


def test_nee_renderer_matches_jax(scenes):
    """One stratified env-only NEE iteration of textured_env at 32x32 depth
    4 through the Renderer (4 lattice dims, salt 0x1D872B41; the textures
    fused on the device; the env shadow rays unbounded occlusion queries,
    through the torus's 8-wide BVH in its any-hit mode) against JAX
    render_radiance with the same wiring. The mixed mode's iterations are
    in tests/test_torch_envnee_render.py."""
    js, ps = (sized(s, nee=True) for s in scenes["env"])
    jcfg, _ = wired(js, ps)
    want = np.asarray(jax.jit(lambda it: JI.render_radiance(
        js.materials, js.camera.flat(), js.geoms, js.meshes, js.textures,
        jax.random.PRNGKey(0), jcfg, packed_meshes=js.packed_meshes,
        iteration=it))(jnp.int32(0)))
    r = Renderer(ps, device="cpu")
    assert r.route == "wavefront" and r.cfg.nee_env and r.cfg.nee_q == 0.0
    got = r.render(1).numpy()
    assert_lane_contract(got.reshape(-1, 3).T, want.reshape(-1, 3).T)
