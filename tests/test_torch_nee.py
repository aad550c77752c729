"""Area-light NEE of the torch port against the JAX package.

The light table (ops/nee.build_light_table) equals the JAX one; the sampler
agrees with both JAX forms (the face unroll and the CDF gather) to 1e-6 on
points and normals and exactly on the light material; shadow rays
(`intersect_planar(any_hit=True, max_t=...)`) report the same occlusion
bits, through primitives and through the torus's 8-wide BVH
(`traverse8_plain` in occlusion mode); `shade_planar` with an injected NEE
tuple holds the lane contract (tests/test_torch_megakernel.py: lanes to
1e-4, at most 1% diverge, means within 0.05); a whole stratified NEE
iteration holds it against JAX `render_radiance(iteration=i)` (every draw
of such an iteration is a hash of (iteration, depth, pixel) in both
packages); gradients of a stratified NEE render match jax.grad to rtol
1e-3.

F3 (ROADMAP Queue 3): a backed-off hit point on cornell's 0.01-thick walls
lies within a float32 rounding step of the wall, so whether a shadow ray
leaves the wall depends on how the point was rounded, and the JAX package's
jitted and eager evaluations of the same iteration disagree on more of the
lanes than the contract's 1%. The port's hit point is fused
(ops/wavefront._fma). So the whole-iteration check holds the port to the
lane contract against the JAX function with a lane counted as agreeing
when it agrees with either JAX evaluation.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.models import inverse as JInv
from project3_cuda_path_tracer_tpu.ops import nee as jnee
from project3_cuda_path_tracer_tpu.ops import wavefront as jwf
from project3_cuda_path_tracer_tpu.ops.vec import V3 as JV3
from project3_cuda_path_tracer_tpu.render import integrator as JI
from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
from project3_cuda_path_tracer_tpu_torch.models import optim
from project3_cuda_path_tracer_tpu_torch.ops import nee as pnee
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
from project3_cuda_path_tracer_tpu_torch.ops.vec import V3
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from project3_cuda_path_tracer_tpu_torch.utils.launches import launch_counts
from test_torch_megakernel import assert_lane_contract

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
TORUS = os.path.join(SCENES, "meshes", "torus.obj")
ATOL, FRAC = 1e-4, 0.01

SPHERE_LIGHT = """MATERIAL 0
RGB 1 1 1
EMITTANCE 8

MATERIAL 1
RGB .8 .8 .8

CAMERA
RES 32 32
FOVY 45
ITERATIONS 8
DEPTH 4
FILE slight
EYE 0 2 6
LOOKAT 0 2 0
UP 0 1 0

OBJECT 0
sphere
material 0
TRANS 0 6 0
ROTAT 0 0 0
SCALE 1.5 1.5 1.5

OBJECT 1
cube
material 1
TRANS 0 -1 0
ROTAT 0 0 0
SCALE 12 .1 12
"""

ELLIPSOID = """MATERIAL 0
RGB 1 1 1
EMITTANCE 4

CAMERA
RES 8 8
FOVY 45
ITERATIONS 2
DEPTH 2
FILE e
EYE 0 0 5
LOOKAT 0 0 0
UP 0 1 0

OBJECT 0
sphere
material 0
TRANS 0 3 0
ROTAT 0 0 0
SCALE 2 1 1
"""

NO_LIGHTS = """MATERIAL 0
RGB .5 .5 .5

CAMERA
RES 16 16
FOVY 45
ITERATIONS 4
DEPTH 2
FILE n
EYE 0 2 6
LOOKAT 0 2 0
UP 0 1 0

OBJECT 0
cube
material 0
TRANS 0 0 0
ROTAT 0 0 0
SCALE 4 .1 4
"""

TORUS_SCENE = """MATERIAL 0
RGB 1 1 1
EMITTANCE 6

MATERIAL 1
RGB .7 .6 .5

CAMERA
RES 16 16
FOVY 45
ITERATIONS 2
DEPTH 3
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


def lights24_text() -> str:
    """24 sphere lights over a floor (the JAX test_many_lights_gather_render
    scene): a table above the JAX unroll limit of 16 faces."""
    mats, objs = [], []
    for i in range(24):
        mats.append(f"MATERIAL {i}\nRGB 1 .8 .6\nEMITTANCE {2 + i % 5}\n")
        objs.append(f"OBJECT {i}\nsphere\nmaterial {i}\n"
                    f"TRANS {-6 + (i % 6) * 2.4:.1f} {3 + (i // 6):.1f} "
                    f"{-3 + (i % 3):.1f}\nROTAT 0 0 0\nSCALE 0.3 0.3 0.3\n")
    mats.append("MATERIAL 24\nRGB .6 .6 .6\n")
    objs.append("OBJECT 24\ncube\nmaterial 24\nTRANS 0 0 0\nROTAT 0 0 0\n"
                "SCALE 16 .1 16\n")
    cam = ("CAMERA\nRES 16 16\nFOVY 40\nITERATIONS 4\nDEPTH 2\nFILE many\n"
           "EYE 0 3 10\nLOOKAT 0 2 0\nUP 0 1 0\n")
    return "\n".join(mats) + "\n" + cam + "\n" + "\n".join(objs)


def scene_path(tmp_path, name: str) -> str:
    """A path for scene `name`: a repo scene, or one of this file's."""
    texts = {"sphere_light": SPHERE_LIGHT, "ellipsoid": ELLIPSOID,
             "no_lights": NO_LIGHTS, "lights24": lights24_text(),
             "torus_nee": TORUS_SCENE}
    if name not in texts:
        return os.path.join(SCENES, name + ".txt")
    if name == "torus_nee":
        (tmp_path / "torus.obj").write_text(open(TORUS).read())
    path = tmp_path / f"{name}.txt"
    path.write_text(texts[name])
    return str(path)


def both(tmp_path, name, res=None, depth=None, stratified=True):
    """(JAX scene, port scene) of `name`, sized."""
    path = scene_path(tmp_path, name)
    js, ps = jax_load_scene(path), load_scene(path)
    for s in (js, ps):
        if res is not None:
            s.camera.resolution = (res, res)
            s.camera.derive()
        if depth is not None:
            s.settings.trace_depth = depth
        s.settings.stratified = stratified
    return js, ps


def nee_cfgs(js, ps):
    """The JAX and port TraceConfigs with NEE wired (`_wire_nee`)."""
    return (JI._wire_nee(js, JI.build_trace_config(js, js.settings)),
            PI._wire_nee(ps, PI.build_trace_config(ps)))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", ["cornell", "lights", "sphere_light",
                                  "lights24", "ellipsoid", "no_lights",
                                  "manylights"])
def test_light_table_matches_jax(tmp_path, name):
    """The same face records and area as the JAX table, float for float;
    the ellipsoid scene and the scene without emitters get the empty
    table."""
    js, ps = both(tmp_path, name)
    jfaces, jarea = jnee.build_light_table(js)
    pfaces, parea = pnee.build_light_table(ps)
    assert pfaces == jfaces and parea == jarea
    if name in ("ellipsoid", "no_lights"):
        assert pfaces == () and parea == 0.0
    else:
        assert len(pfaces[0]) == pnee.FACE_LEN and pfaces[-1][0] == 1.0
    if name == "sphere_light":
        assert len(pfaces) == 1 and pfaces[0][1] == 1.0
        assert parea == pytest.approx(4 * np.pi * 0.75 ** 2, rel=1e-4)


@pytest.mark.parametrize("name", ["cornell", "lights", "lights24",
                                  "manylights256"])
def test_sampler_matches_both_jax_forms(tmp_path, name):
    """The port's one gather form against the JAX unroll (small tables) and
    gather (large ones) on the same uniforms: points and normals to 1e-6,
    the light material exactly."""
    js, ps = both(tmp_path, name)
    faces, _ = pnee.build_light_table(ps)
    rng = np.random.default_rng(5)
    u = rng.random((3, 4096), dtype=np.float32)
    lp, ln, lm = pnee.sample_lights_planar(faces, *(_t(c) for c in u))
    forms = [jnee._sample_lights_gather]
    if len(faces) <= jnee.UNROLL_MAX_FACES:
        forms.append(jnee.sample_lights_planar)
    for form in forms:
        jlp, jln, jlm = form(faces, *(_j(c) for c in u))
        for g, w in zip((*lp, *ln), (*jlp, *jln)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
        np.testing.assert_array_equal(lm.numpy(), np.asarray(jlm))


def _shadow_rays(n, seed, lo, hi):
    """Origins uniform in the box [lo, hi], unit directions, and a max_t in
    (0.5, 12)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    max_t = rng.uniform(0.5, 12.0, n).astype(np.float32)
    return o, d, max_t


@pytest.mark.parametrize("name", ["cornell", "torus_nee"])
def test_occlusion_bits_match_jax(tmp_path, name):
    """`intersect_planar(any_hit=True, max_t=...)`: a hit beyond max_t is a
    miss (t = -1); the occlusion bit (t > 0) agrees with the JAX query on
    >= 99.9% of the lanes (a decision at a float tie may flip), and with the
    port's own nearest-hit query on every lane. On the torus scene the mesh
    goes through the 8-wide BVH in occlusion mode (traverse8_plain)."""
    js, ps = both(tmp_path, name)
    n = 4096
    o, d, max_t = _shadow_rays(n, 7, [-4.5, 0.5, -4.5], [4.5, 6.0, 4.5])
    alive = np.random.default_rng(8).random(n) < 0.95
    gt = tuple(int(t) for t in np.asarray(js.geoms.type))
    mids = tuple(int(m) for m in np.asarray(js.geoms.mesh_id))
    jh = jwf.intersect_planar(
        JV3(*(_j(o[:, i]) for i in range(3))),
        JV3(*(_j(d[:, i]) for i in range(3))), jnp.zeros(n), js.geoms,
        js.meshes, gt, js.packed_meshes, mids, alive=_j(alive),
        any_hit=True, max_t=_j(max_t))
    po = V3(*(_t(o[:, i]) for i in range(3)))
    pd = V3(*(_t(d[:, i]) for i in range(3)))
    kw = dict(alive=_t(alive), max_t=_t(max_t))
    calls = launch_counts()
    ph = wf.intersect_planar(po, pd, torch.zeros(n), ps.geoms, gt,
                             ps.packed_meshes, mids, any_hit=True, **kw)
    near = wf.intersect_planar(po, pd, torch.zeros(n), ps.geoms, gt,
                               ps.packed_meshes, mids, **kw)
    assert launch_counts() == calls  # CPU tensors: the plain traversal
    occl = ph.t.numpy() > 0
    assert 0.05 < occl.mean() < 0.95
    assert (ph.t.numpy()[~occl] == -1.0).all()
    assert (ph.t.numpy()[occl] < max_t[occl]).all()
    np.testing.assert_array_equal(occl, near.t.numpy() > 0)
    assert (occl == (np.asarray(jh.t) > 0)).mean() >= 0.999
    if name == "torus_nee":
        mesh = (near.mat_id.numpy() == 1) & occl
        assert mesh.sum() > 50


@pytest.mark.parametrize("name,glossy", [("cornell", False),
                                         ("cornell_glossy", True),
                                         ("lights", False)])
def test_shade_with_nee_matches_jax(tmp_path, name, glossy):
    """shade_planar on the same hit records, ray state, uniforms and an
    injected NEE tuple (random directions, visibility, emission, light pdf
    and previous lobe pdf, a quarter of them 0) as JAX's
    shade_planar(nee=...), with the MIS weight on emissive hits on."""
    js, ps = both(tmp_path, name, res=16)
    n = 4096
    o, d, _ = _shadow_rays(n, 3, [-4.5, 0.5, -4.5], [4.5, 9.5, 4.5])
    jo = JV3(*(_j(o[:, i]) for i in range(3)))
    jd = JV3(*(_j(d[:, i]) for i in range(3)))
    gt = tuple(int(t) for t in np.asarray(js.geoms.type))
    jh = jwf.intersect_planar(jo, jd, jnp.zeros(n), js.geoms, js.meshes, gt)
    ph = wf.HitP(t=_t(jh.t), normal=V3(*(_t(c) for c in jh.normal)),
                 mat_id=_t(jh.mat_id).long(),
                 point=V3(*(_t(c) for c in jh.point)),
                 surf=V3(*(_t(c) for c in jh.surf)), u=_t(jh.u),
                 v=_t(jh.v), outside=_t(jh.outside))
    rng = np.random.default_rng(4)
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
    faces, area = pnee.build_light_table(ps)
    jout = jwf.shade_planar(
        jh, jd, JV3(*(_j(c) for c in thr)), _j(alive), js.materials,
        js.textures, _j(u), last_bounce=_j(last), glossy=glossy, sky=False,
        nee=(JV3(*(_j(c) for c in wl)), _j(vis), JV3(*(_j(c) for c in le)),
             _j(pdf_l), _j(prev)), nee_area=area)
    pout = wf.shade_planar(
        ph, V3(*(_t(d[:, i]) for i in range(3))), V3(*(_t(c) for c in thr)),
        _t(alive), ps.materials, ps.textures, _t(u), last_bounce=_t(last),
        glossy=glossy,
        nee=(V3(*(_t(c) for c in wl)), _t(vis), V3(*(_t(c) for c in le)),
             _t(pdf_l), _t(prev)), nee_area=area)
    for k in ("origin", "direction", "throughput", "radiance"):
        assert_lane_contract(np.stack([c.numpy() for c in getattr(pout, k)]),
                             np.stack([np.asarray(c)
                                       for c in getattr(jout, k)]))
    assert_lane_contract(pout.nee_pdf.numpy()[None],
                         np.asarray(jout.nee_pdf)[None])
    np.testing.assert_array_equal(pout.alive.numpy(), np.asarray(jout.alive))
    assert float(pout.radiance.x.abs().sum()) > 0


def agree_with_jax(got, jitted, eager):
    """Lane mask: the port's [N, 3] radiance within ATOL of the JAX
    package's jitted or its eager evaluation (module docstring, F3)."""
    def near(w):
        return (np.abs(got - w) <= ATOL).all(axis=-1)
    return near(jitted) | near(eager)


@pytest.mark.parametrize("name", ["cornell", "lights"])
def test_stratified_nee_iteration_matches_jax(tmp_path, name):
    """24x24 depth 4, stratified NEE, iterations 0 and 1: the port's trace
    (Renderer on the CPU, the wavefront route) against JAX render_radiance
    with `_wire_nee`'s config, under the lane contract (module docstring);
    the image means within 0.05 of the jitted evaluation."""
    res = 24
    js, ps = both(tmp_path, name, res=res, depth=4)
    jcfg, _ = nee_cfgs(js, ps)

    def jrender(it):
        return JI.render_radiance(js.materials, js.camera.flat(), js.geoms,
                                  js.meshes, js.textures,
                                  jax.random.PRNGKey(0), jcfg, iteration=it)
    jitted = jax.jit(jrender)
    ps.settings.nee = True
    r = Renderer(ps, device="cpu")
    assert r.route == "wavefront" and r.cfg.nee
    for it in range(2):
        want = np.asarray(jitted(jnp.int32(it))).reshape(-1, 3)
        with jax.disable_jit():
            eager = np.asarray(jrender(jnp.int32(it))).reshape(-1, 3)
        before = r.accum.clone()
        r.step()
        got = (r.accum - before).numpy().reshape(-1, 3)
        assert np.isfinite(got).all()
        assert (~agree_with_jax(got, want, eager)).mean() <= FRAC
        assert np.abs(got.mean(0) - want.mean(0)).max() < 0.05


def test_nee_matches_plain_in_expectation(tmp_path):
    """NEE covers the plain estimator's transport at equal depth: on the
    sphere-light scene (32x32, depth 4, 96 spp each, pseudo-random draws)
    the two image means agree within 3% (the JAX test_sphere_light
    tolerance)."""
    _, ps = both(tmp_path, "sphere_light", stratified=False)
    plain = Renderer(ps, device="cpu").render(96).mean()
    ps.settings.nee = True
    r = Renderer(ps, device="cpu")
    assert r.cfg.nee and r.route == "wavefront"
    lit = r.render(96).mean()
    assert abs(float(lit) - float(plain)) < 0.03 * float(plain)


RES, DEPTH, IT = 16, 3, 5


@pytest.mark.parametrize("name", ["cornell", "lights"])
def test_nee_gradients_match_jax(tmp_path, name):
    """The history loss's gradient on every RenderParams leaf (materials
    and camera) under stratified NEE at 16x16 depth 3, port autograd
    against jax.grad to rtol 1e-3 (the method of
    tests/test_torch_inverse.py: lanes where the two renders diverge carry
    no weight; at most 1% may diverge from both JAX evaluations)."""
    js, ps = both(tmp_path, name, res=RES, depth=DEPTH)
    jcfg, pcfg = nee_cfgs(js, ps)
    rng = np.random.default_rng(0)
    target = rng.random((RES, RES, 3), dtype=np.float32) * 0.5
    resid = rng.random((RES, RES, 3), dtype=np.float32)

    def loss(p, resid):
        img = JI.render_radiance(p.materials, p.cam, js.geoms, js.meshes,
                                 js.textures, jax.random.PRNGKey(0), jcfg,
                                 iteration=jnp.int32(IT))
        return 2.0 * jnp.mean((resid - target) * img), img

    jparams = JInv.RenderParams(materials=js.materials, cam=js.camera.flat())
    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (_, jimg), _ = vg(jparams, jnp.asarray(resid))
    with jax.disable_jit():
        eager = np.asarray(loss(jparams, jnp.asarray(resid))[1])

    params = PInv.params_from_scene(ps, device="cpu")
    img = PInv.render_image(params, ps.geoms, ps.meshes, ps.textures, None,
                            pcfg, iteration=IT).detach().numpy()
    agree = agree_with_jax(img.reshape(-1, 3), np.asarray(jimg).reshape(
        -1, 3), eager.reshape(-1, 3))
    assert (~agree).mean() <= FRAC
    diverged = (np.abs(img - np.asarray(jimg)) > ATOL).any(axis=-1)
    resid = np.where(diverged[..., None], target, resid)

    (jloss, _), jgrads = vg(jparams, jnp.asarray(resid))
    ploss, _ = PInv.history_residual_grad_loss(
        params, ps.geoms, ps.meshes, ps.textures, None, pcfg,
        torch.from_numpy(target), torch.from_numpy(resid), iteration=IT)
    leaves = PInv.param_leaves(params)
    pgrads = torch.autograd.grad(ploss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(ploss.detach()), float(jloss),
                               rtol=1e-3)
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(jparams)]
    for what, want, got, leaf in zip(names, jax.tree_util.tree_leaves(jgrads),
                                     pgrads, leaves):
        got = torch.zeros_like(leaf) if got is None else got
        assert torch.isfinite(got).all(), what
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-7, err_msg=what)
    # the lights' emittance reaches the loss through the direct term
    emit = dict(zip(names, pgrads))[".materials.emittance"]
    assert float(emit.abs().max()) > 0


def test_nee_train_step(tmp_path):
    """One two-render train step (make_train_step) on cornell 24x24 depth 3
    with NEE: the loss is finite, the albedo moves, and the light's
    emittance gets a positive gradient against a black target (the JAX
    test_train_step_with_nee and test_nee_gradients)."""
    _, ps = both(tmp_path, "cornell", res=24, depth=3, stratified=False)
    pcfg = PI._wire_nee(ps, PI.build_trace_config(ps))
    assert pcfg.nee and len(pcfg.nee_lights) == 6
    params = PInv.params_from_scene(ps, device="cpu")
    before = params.materials.color.detach().clone()
    step = PInv.make_train_step(ps.geoms, ps.meshes, ps.textures, pcfg)
    opt_state = optim.init(PInv.param_leaves(params))
    params, opt_state, loss = step(params, opt_state,
                                   PInv.step_generator(0, 0, "cpu"),
                                   torch.zeros((24, 24, 3)))
    assert np.isfinite(float(loss))
    assert not torch.equal(params.materials.color.detach(), before)
    mse = PInv.mse_loss(params, ps.geoms, ps.meshes, ps.textures,
                        PInv.step_generator(0, 1, "cpu"), pcfg,
                        torch.zeros((24, 24, 3)))
    (g_emit,) = torch.autograd.grad(mse, [params.materials.emittance])
    assert float(g_emit[0]) > 0  # material 0 is cornell's light


def test_route_and_drops(tmp_path, capsys):
    """NEE takes the wavefront route even where the megakernel could render
    the scene; plain cornell keeps the megakernel; a scene without
    eligible emitters drops NEE (and ReSTIR) on one stderr line and
    renders plain."""
    path = os.path.join(SCENES, "cornell.txt")
    assert Renderer(load_scene(path), device="cpu").route == "megakernel"
    scene = load_scene(path)
    scene.settings.nee = True
    r = Renderer(scene, device="cpu")
    assert r.route == "wavefront" and r.cfg.nee and not r.drops
    assert capsys.readouterr().err == ""
    for name in ("no_lights", "ellipsoid"):
        _, ps = both(tmp_path, name)
        ps.settings.restir = 2
        before = launch_counts()
        r = Renderer(ps, device="cpu")
        assert not r.cfg.nee and not r.cfg.restir and r.reservoir is None
        err = capsys.readouterr().err.strip().splitlines()
        assert len(err) == 1 and err[0].startswith("features dropped: nee")
        assert "restir" in err[0]
        r.render(2)
        assert np.isfinite(r.image()).all() and launch_counts() == before


def test_light_draws_keep_the_base_stream(tmp_path):
    """Enabling NEE does not shift the camera and BSDF draws: a pseudo-
    random trace whose shade uniforms come from the generator gives the
    same first-bounce rays with and without NEE, because the light planes
    come from their own generator."""
    _, ps = both(tmp_path, "cornell", res=8, depth=1, stratified=False)
    plain_cfg = PI.build_trace_config(ps)
    nee_cfg = PI._wire_nee(ps, plain_cfg)
    seen = []
    real = wf.shade_planar

    def spy(*args, **kwargs):
        seen.append(torch.stack(list(args[6])))
        return real(*args, **kwargs)
    wf.shade_planar = spy
    try:
        for cfg in (plain_cfg, nee_cfg):
            gen = torch.Generator().manual_seed(3)
            PI.trace_wavefront(ps.materials, ps.camera.flat(), ps.geoms,
                               ps.textures, cfg, generator=gen)
    finally:
        wf.shade_planar = real
    assert torch.equal(seen[0], seen[1])
