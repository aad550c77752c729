"""The train step through textured, SDF and dispersive scenes: the port's
autograd against jax.grad of the JAX `render_radiance` on the same
stratified trace, per RenderParams leaf.

The contract is tests/test_torch_inverse.py's: both packages render
iteration IT with `stratified=True`, at most FRAC = 1% of lanes may
diverge at a decision threshold (a texel index, the march's convergence
mask, the dispersion band), those lanes get no weight (their residual is
set to the target), and the loss and every leaf's gradient agree to
rtol 1e-3. The port's textures are fused once (`texfetch.fuse`), as the
Renderer and the InverseRenderer hold them; the JAX trace runs the
torus's 8-wide traversal in Pallas interpret mode.

Cases: textured_env's atlas (nearest, --bilinear, --bilinear-fast) with
its env map, textured_env_proc's checker and sky, the bump and
normal-map scene of tests/test_torch_textures.py, sdf.txt's three SDF
kinds and dispersion.txt. Then a few InverseRenderer steps on a textured
scene, and the memory schedule (`TraceConfig.remat`): checkpointed
bounces give the plain bounces' gradients bit for bit on the same draws.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.models import inverse as JInv
from project3_cuda_path_tracer_tpu.render import integrator as JI
from project3_cuda_path_tracer_tpu.scene import types as JT
from project3_cuda_path_tracer_tpu_torch import load_scene
from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
from project3_cuda_path_tracer_tpu_torch.ops import texfetch
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from test_torch_inverse import FRAC, IT, RTOL, _leaf_names, _sized
from test_torch_textures import bump_scene_path

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
RES = 16


def check_textured_grads(js, ps):
    """The history loss's gradient on every leaf, port against jax.grad
    (module docstring); returns the port's gradients by leaf name."""
    mesh = bool((np.asarray(js.geoms.type) == JT.MESH).any())
    jcfg = dataclasses.replace(JI.build_trace_config(js, js.settings),
                               differentiable_mesh=mesh)
    pcfg = dataclasses.replace(PInv.train_config(ps), stratified=True,
                               dof=bool(jcfg.dof), motion=bool(jcfg.motion))
    assert pcfg.differentiable_mesh == mesh
    tex = texfetch.fuse(ps.textures)
    rng = np.random.default_rng(0)
    target = rng.random((RES, RES, 3), dtype=np.float32) * 0.5
    resid = rng.random((RES, RES, 3), dtype=np.float32)

    def loss(p, resid):
        img = JI.render_radiance(p.materials, p.cam, js.geoms, js.meshes,
                                 js.textures, jax.random.PRNGKey(0), jcfg,
                                 packed_meshes=js.packed_meshes,
                                 iteration=jnp.int32(IT))
        return 2.0 * jnp.mean((resid - target) * img), img

    jparams = JInv.RenderParams(materials=js.materials, cam=js.camera.flat())
    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (_, jimg), _ = vg(jparams, jnp.asarray(resid))

    params = PInv.params_from_scene(ps, device="cpu")
    img = PInv.render_image(params, ps.geoms, ps.meshes, tex, None, pcfg,
                            ps.packed_meshes, iteration=IT)
    assert np.isfinite(img.detach().numpy()).all()
    diverged = (np.abs(img.detach().numpy() - np.asarray(jimg))
                > 1e-4).any(axis=-1)
    assert diverged.mean() <= FRAC, f"{diverged.sum()} lanes diverge"
    resid = np.where(diverged[..., None], target, resid)

    (jloss, _), jgrads = vg(jparams, jnp.asarray(resid))
    ploss, _ = PInv.history_residual_grad_loss(
        params, ps.geoms, ps.meshes, tex, None, pcfg,
        torch.from_numpy(target), torch.from_numpy(resid), ps.packed_meshes,
        iteration=IT)
    leaves = PInv.param_leaves(params)
    pgrads = torch.autograd.grad(ploss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(ploss.detach()), float(jloss),
                               rtol=RTOL)
    names = _leaf_names(jparams)
    assert len(names) == len(leaves)
    out = {}
    for what, want, got, leaf in zip(names, jax.tree_util.tree_leaves(jgrads),
                                     pgrads, leaves):
        got = torch.zeros_like(leaf) if got is None else got
        assert torch.isfinite(got).all(), what
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=1e-7, err_msg=what)
        out[what] = got
    assert max(float(g.abs().max()) for g in out.values()) > 1e-3
    return out


def _pair(path, res=RES, **settings):
    js, ps = (_sized(s, res=res) for s in (jax_load_scene(path),
                                           load_scene(path)))
    for s in (js, ps):
        for k, v in settings.items():
            setattr(s.settings, k, v)
    return js, ps


def sphere_twin(tmp_path) -> str:
    """textured_env with a textured sphere in the torus's place (the same
    atlas material), its assets by absolute path."""
    with open(os.path.join(SCENES, "textured_env.txt")) as f:
        text = f.read()
    text = (text.replace("mesh meshes/torus.obj", "sphere")
            .replace("assets/", os.path.join(SCENES, "assets") + "/"))
    path = tmp_path / "textured_env_sphere.txt"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bilinear_fast"])
def test_atlas_and_env_grads_match_jax(mode, tmp_path):
    """The atlas (its texels through P1's plain gather), the env map on
    every miss and the fused fetch, in each filtering mode. Nearest runs
    on textured_env itself, the atlas on the floor and on the torus, whose
    hits are recomputed differentiably. The filtered modes run on its
    sphere twin: jax.grad of a bilinear fetch behind the torus's
    interpret-mode traversal did not finish compiling in 15 minutes on the
    CPU, while the twin's takes ~15 s."""
    path = (os.path.join(SCENES, "textured_env.txt") if mode == "nearest"
            else sphere_twin(tmp_path))
    js, ps = _pair(path, bilinear=mode != "nearest",
                   bilinear_fast=mode == "bilinear_fast")
    check_textured_grads(js, ps)


def test_checker_and_sky_grads_match_jax():
    """textured_env_proc: the procedural checker and the sky's analytic
    terms (no texel fetch)."""
    js, ps = _pair(os.path.join(SCENES, "textured_env_proc.txt"))
    assert PInv.train_config(ps).sky
    check_textured_grads(js, ps)


def test_bump_and_normal_map_grads_match_jax(tmp_path):
    """The bump map's and the normal map's tangent frames."""
    js, ps = _pair(bump_scene_path(tmp_path))
    cfg = PInv.train_config(ps)
    assert cfg.bump and cfg.nmap
    check_textured_grads(js, ps)


def test_sdf_grads_match_jax():
    """sdf.txt: the torus, the metaball and the CSG difference, through
    the march's 64 masked steps and the finite-difference normal."""
    js, ps = _pair(os.path.join(SCENES, "sdf.txt"))
    assert len(PInv.train_config(ps).sdf_kinds) == len(ps.sdf_kinds) > 0
    check_textured_grads(js, ps)


def test_dispersion_grads_match_jax():
    """dispersion.txt: the per-band ior chain; its ior and dispersion
    leaves carry the gradients JAX gives them."""
    js, ps = _pair(os.path.join(SCENES, "dispersion.txt"))
    assert PInv.train_config(ps).dispersion
    got = check_textured_grads(js, ps)
    assert ".materials.dispersion" in got


@pytest.mark.parametrize("name", ["textured_env", "sdf", "dispersion"])
def test_train_config_takes_the_renderers_scene_fields(name):
    """The train step's config carries every scene field the forward
    Renderer's does (textures, SDF kinds, dispersion, the sky), and none
    of its render-only knobs."""
    ps = load_scene(os.path.join(SCENES, name + ".txt"))
    ps.settings.russian_roulette = ps.settings.nee = True
    fwd = PI.build_trace_config(ps)
    cfg = PInv.train_config(ps)
    for f in ("geom_types", "mesh_ids", "glossy", "sky", "bump", "nmap",
              "bilinear", "bilinear_fast", "sdf_kinds", "dispersion"):
        assert getattr(cfg, f) == getattr(fwd, f), f
    assert not (cfg.russian_roulette or cfg.nee or cfg.stratified)
    # the JAX rule (mesh scenes, above 800x800 at depth 8) and SDF scenes
    assert cfg.remat == (name in ("textured_env", "sdf"))


def test_inverse_renderer_steps_on_a_textured_scene():
    """A few InverseRenderer steps on textured_env at 16x16 depth 3 (the
    history step with its polish tail): finite losses, and the
    parameters move (the specular colour: the albedo of this scene comes
    from its atlas, so the colour table takes no gradient)."""
    ps = _sized(load_scene(os.path.join(SCENES, "textured_env.txt")),
                stratified=False)
    target = np.full((RES, RES, 3), 0.25, np.float32)
    inv = PInv.InverseRenderer(ps, target, learning_rate=5e-2,
                               polish_steps=1, device="cpu")
    assert inv.cfg.remat and inv.cfg.differentiable_mesh
    before = inv.params.materials.specular_color.detach().clone()
    losses = inv.fit(3)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert all(torch.isfinite(t).all()
               for t in PInv.param_leaves(inv.params))
    moved = (inv.params.materials.specular_color.detach() - before).abs()
    assert float(moved.max()) > 0


@pytest.mark.parametrize("name", ["textured_env", "sdf"])
def test_remat_gradients_equal_plain(name):
    """Checkpointed bounces (`TraceConfig.remat`) against plain ones on the
    same draws (pseudo-random, from one seed): the forward image and
    every gradient bit for bit. The draws are taken before each
    checkpointed bounce, so the recompute sees the same numbers."""
    ps = _sized(load_scene(os.path.join(SCENES, name + ".txt")),
                stratified=False)
    tex = texfetch.fuse(ps.textures)
    target = torch.full((RES, RES, 3), 0.2)
    out = []
    for remat in (False, True):
        cfg = PInv.train_config(ps, remat=remat)
        params = PInv.params_from_scene(ps, device="cpu")
        gen = PInv.step_generator(3, 0, "cpu")
        loss = PInv.mse_loss(params, ps.geoms, ps.meshes, tex, gen, cfg,
                             target, ps.packed_meshes)
        grads = torch.autograd.grad(loss, PInv.param_leaves(params),
                                    allow_unused=True)
        out.append((loss.detach(), grads))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_jax_inverse_renderer_config_lacks_scene_fields():
    """ROADMAP F10, a property of the reference: the JAX InverseRenderer
    builds its TraceConfig without the scene's SDF kinds, dispersion, bump
    or normal map (JAX models/inverse.py InverseRenderer.__init__), so its
    train step cannot trace sdf.txt (the SDF branch indexes the empty
    kinds) and trains dispersion.txt through a render without dispersion.
    The port's train step takes the forward Renderer's fields
    (`train_config`)."""
    for name in ("sdf", "dispersion"):
        path = os.path.join(SCENES, name + ".txt")
        js = _sized(jax_load_scene(path), res=4, depth=1)
        jir = JInv.InverseRenderer(js, np.zeros((4, 4, 3), np.float32))
        fwd = JI.build_trace_config(js, js.settings)
        pcfg = PInv.train_config(_sized(load_scene(path), res=4, depth=1))
        if name == "sdf":
            assert jir.cfg.sdf_kinds == () and fwd.sdf_kinds
            assert pcfg.sdf_kinds == tuple(fwd.sdf_kinds)
            with pytest.raises(IndexError):
                JI.render_radiance(js.materials, js.camera.flat(), js.geoms,
                                   js.meshes, js.textures,
                                   jax.random.PRNGKey(0), jir.cfg)
        else:
            assert not jir.cfg.dispersion and fwd.dispersion
            assert pcfg.dispersion
