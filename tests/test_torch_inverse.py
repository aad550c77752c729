"""The port's train step (models/inverse.py, models/optim.py) against the
JAX package: gradients against jax.grad, Adam against optax.adam, the
train loops and InverseRenderer (tests/test_torch_train.py has the mesh
scene and the fit).

Gradients: with `stratified=True` every draw of a render is a hash of
(iteration, depth, pixel), the same in both packages, so the port's
autograd and jax.grad differentiate the same trace. The loss is the
history-residual loss 2*mean((residual - target) * image), built on
JAX `render_radiance(..., iteration=i)` on the JAX side (the JAX train step
cannot pin its draws). Lanes may diverge at decision thresholds (the lane
contract of tests/test_torch_megakernel.py allows 1%); one divergent lane
of 256 moves a 16x16 loss by several percent, so the test first renders
both images, asserts that at most 1% of lanes diverge, and sets the
residual to the target there: those lanes then carry no weight, and on the
rest the gradients must agree to rtol 1e-3.

Under the plain estimator (no NEE) the geometric chains (IOR, SPECEX, the
lens, the camera) carry exactly zero gradient in both packages: cosine
sampling cancels every geometric factor (the JAX tests/test_grad.py
`_fd_material_scalar` docstring). On those leaves the test checks the
0*inf guards: a NaN anywhere on such a chain would show in the sum.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.models import inverse as JInv
from project3_cuda_path_tracer_tpu.render import integrator as JI
from project3_cuda_path_tracer_tpu_torch import load_scene
from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
from project3_cuda_path_tracer_tpu_torch.models import optim
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from project3_cuda_path_tracer_tpu_torch.scene.convert import (
    adam_state_from_numpy, render_params_from_numpy)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
RES, DEPTH, IT = 16, 3, 5
FRAC = 0.01      # the lane contract's share of divergent lanes
RTOL = 1e-3


def _sized(s, res=RES, depth=DEPTH, stratified=True):
    s.camera.resolution = (res, res)
    s.camera.derive()
    s.settings.trace_depth = depth
    s.settings.stratified = stratified
    return s


def _leaf_names(params):
    return [jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_leaves_with_path(params)]


def check_grads_match_jax(js, ps, mesh=False):
    """The history loss's gradient on every RenderParams leaf, port against
    jax.grad, at 16x16, stratified iteration IT (module docstring)."""
    jcfg = dataclasses.replace(JI.build_trace_config(js, js.settings),
                               differentiable_mesh=mesh)
    pcfg = dataclasses.replace(PI.build_trace_config(ps),
                               differentiable_mesh=mesh)
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
    img = PInv.render_image(params, ps.geoms, ps.meshes, ps.textures, None,
                            pcfg, ps.packed_meshes, iteration=IT)
    diverged = (np.abs(img.detach().numpy() - np.asarray(jimg))
                > 1e-4).any(axis=-1)
    assert diverged.mean() <= FRAC, f"{diverged.sum()} lanes diverge"
    resid = np.where(diverged[..., None], target, resid)

    (jloss, _), jgrads = vg(jparams, jnp.asarray(resid))
    ploss, _ = PInv.history_residual_grad_loss(
        params, ps.geoms, ps.meshes, ps.textures, None, pcfg,
        torch.from_numpy(target), torch.from_numpy(resid), ps.packed_meshes,
        iteration=IT)
    leaves = PInv.param_leaves(params)
    pgrads = torch.autograd.grad(ploss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(ploss.detach()), float(jloss),
                               rtol=RTOL)
    names = _leaf_names(jparams)
    assert len(names) == len(leaves)
    for what, want, got, leaf in zip(names, jax.tree_util.tree_leaves(jgrads),
                                     pgrads, leaves):
        got = torch.zeros_like(leaf) if got is None else got
        assert torch.isfinite(got).all(), what
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=1e-7, err_msg=what)
    color = pgrads[0]
    assert color is not None and float(color.abs().max()) > 1e-3


@pytest.mark.parametrize("name", ["cornell", "cornell_glass",
                                  "cornell_glossy", "cornell_dof"])
def test_grads_match_jax(name):
    """cornell (albedo, emittance, lobe probabilities), cornell_glass (the
    IOR chain), cornell_glossy (the SPECEX chain), cornell_dof (the lens
    chain)."""
    path = os.path.join(SCENES, name + ".txt")
    check_grads_match_jax(_sized(jax_load_scene(path)),
                          _sized(load_scene(path)))


@pytest.mark.parametrize("name", ["cornell", "cornell_glass",
                                  "cornell_glossy", "cornell_dof"])
def test_grads_finite_everywhere(name):
    """mse_loss against a black target, pseudo-random draws: every leaf's
    gradient is finite (the JAX test_mse_loss_grad_finite_everywhere)."""
    ps = _sized(load_scene(os.path.join(SCENES, name + ".txt")),
                stratified=False)
    cfg = PI.build_trace_config(ps)
    params = PInv.params_from_scene(ps, device="cpu")
    gen = PInv.step_generator(0, 0, "cpu")
    loss = PInv.mse_loss(params, ps.geoms, ps.meshes, ps.textures, gen, cfg,
                         torch.zeros((RES, RES, 3)))
    for g in torch.autograd.grad(loss, PInv.param_leaves(params),
                                 allow_unused=True):
        assert g is None or torch.isfinite(g).all()


def test_clamp_gradient_splits_at_ties_like_jax():
    """The port fault the gradient check found (ROADMAP F4): at a tie with
    its bound, jnp.maximum and jnp.clip pass half the gradient, where
    torch.clamp passed all of it. Cornell's diffuse materials sit at REFL =
    REFR = 0, on the lower bound of the lobe probabilities' clip, so their
    gradients came out twice JAX's."""
    x = [0.0, 0.5, 1.0, -1.0, 2.0]
    for port, ref in ((lambda t: wf._max(t, 0.0),
                       lambda t: jnp.maximum(t, 0.0)),
                      (lambda t: wf._clip(t, 0.0, 1.0),
                       lambda t: jnp.clip(t, 0.0, 1.0))):
        t = torch.tensor(x, requires_grad=True)
        got, = torch.autograd.grad(port(t).sum(), t)
        want = jax.grad(lambda a: ref(a).sum())(jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[0] == 0.5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_matches_optax(steps):
    """From a state optax reached in two steps, carried across by
    scene/convert.py: `steps` more steps with the same random gradients.
    `aperture` and `shutter` get None in the port and zeros in optax: they
    still move (momentum), as optax moves them, where torch.optim.Adam
    would skip them."""
    js = jax_load_scene(os.path.join(SCENES, "cornell_dof.txt"))
    jparams = JInv.RenderParams(materials=js.materials, cam=js.camera.flat())
    opt = optax.adam(1e-2)
    state = opt.init(jparams)
    rng = np.random.default_rng(steps)

    def rand_like(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=np.shape(a)), jnp.float32),
            tree)

    for _ in range(2):
        upd, state = opt.update(rand_like(jparams), state, jparams)
        jparams = optax.apply_updates(jparams, upd)
    params = render_params_from_numpy(_np(jparams), device="cpu")
    pstate = adam_state_from_numpy(_np(state[0]), device="cpu")
    leaves = PInv.param_leaves(params)
    names = _leaf_names(jparams)
    dropped = {names.index(".cam['aperture']"),
               names.index(".cam['shutter']")}
    before = [t.detach().clone() for t in leaves]
    for _ in range(steps):
        g = rand_like(jparams)
        g_leaves, treedef = jax.tree_util.tree_flatten(g)
        g_leaves = [jnp.zeros_like(a) if i in dropped else a
                    for i, a in enumerate(g_leaves)]
        upd, state = opt.update(jax.tree_util.tree_unflatten(treedef,
                                                             g_leaves),
                                state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        pstate = optim.update(
            leaves, [None if i in dropped else torch.from_numpy(np.array(a))
                     for i, a in enumerate(g_leaves)], pstate, 1e-2)
    assert int(pstate.count) == int(state[0].count) == 2 + steps
    for kind, want, got in (("param", jax.tree_util.tree_leaves(jparams),
                             leaves),
                            ("mu", jax.tree_util.tree_leaves(state[0].mu),
                             pstate.mu),
                            ("nu", jax.tree_util.tree_leaves(state[0].nu),
                             pstate.nu)):
        for what, w, g in zip(names, want, got):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{kind} {what}")
    for i in dropped:
        assert not torch.equal(leaves[i].detach(), before[i])


def _cornell(depth=2):
    return _sized(load_scene(os.path.join(SCENES, "cornell.txt")),
                  depth=depth, stratified=False)


@pytest.mark.parametrize("history", [False, True])
def test_train_scan_equals_sequential_steps(history):
    """make_train_scan's loop equals the make_train_step calls with the
    same per-step generators, bit for bit (the JAX scan-vs-steps tests)."""
    ps = _cornell()
    cfg = PI.build_trace_config(ps)
    tables = (ps.geoms, ps.meshes, ps.textures)
    target = torch.zeros((RES, RES, 3))
    n = 3
    seed_hist = PInv.make_seed_history(*tables, cfg)

    def start():
        p = PInv.params_from_scene(ps, device="cpu")
        hist = seed_hist(p, PInv.step_generator(99, 0, "cpu"))
        return p, optim.init(PInv.param_leaves(p)), hist

    step = PInv.make_train_step(*tables, cfg, history=history)
    p1, s1, h1 = start()
    seq = []
    for i in range(n):
        gen = PInv.step_generator(7, i, "cpu")
        if history:
            p1, s1, h1, loss = step(p1, s1, h1, gen, target)
        else:
            p1, s1, loss = step(p1, s1, gen, target)
        seq.append(loss)
    run = PInv.make_train_scan(*tables, cfg, num_steps=n, history=history)
    p2, s2, h2 = start()
    if history:
        p2, s2, h2, losses = run(p2, s2, h2, 7, target)
        assert torch.equal(h1, h2)
    else:
        p2, s2, losses = run(p2, s2, 7, target)
    assert torch.equal(losses, torch.stack(seq))
    for a, b in zip(PInv.param_leaves(p1) + s1.mu + s1.nu,
                    PInv.param_leaves(p2) + s2.mu + s2.nu):
        assert torch.equal(a, b)
    assert int(s2.count) == n
    color0 = load_scene(os.path.join(SCENES, "cornell.txt")).materials.color
    assert not torch.equal(p2.materials.color.detach(), color0)


@pytest.mark.parametrize("draws", ["generator", "stratified"])
def test_history_grad_equals_unbiased_when_residual_is_fresh(draws):
    """With the residual an independent render at the same params,
    history_residual_grad_loss's gradient is the unbiased loss's (the
    same graph, the detached factor hoisted out)."""
    ps = _cornell(depth=3)
    ps.settings.stratified = draws == "stratified"
    cfg = PI.build_trace_config(ps)
    tables = (ps.geoms, ps.meshes, ps.textures)
    params = PInv.params_from_scene(ps, device="cpu")
    leaves = PInv.param_leaves(params)
    target = torch.full((RES, RES, 3), 0.25)
    strat = draws == "stratified"

    def gen():
        return None if strat else PInv.step_generator(12, 0, "cpu")
    g = gen()
    loss = PInv.unbiased_mse_grad_loss(params, *tables, g, cfg, target,
                                       iterations=(0, 1) if strat
                                       else (None, None))
    g_two = torch.autograd.grad(loss, leaves, allow_unused=True)
    g = gen()
    residual = PInv.make_seed_history(*tables, cfg)(params, g,
                                                    0 if strat else None)
    loss, _ = PInv.history_residual_grad_loss(params, *tables, g, cfg,
                                              target, residual,
                                              iteration=1 if strat else None)
    g_hist = torch.autograd.grad(loss, leaves, allow_unused=True)
    for a, b in zip(g_two, g_hist):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def test_inverse_renderer_history_and_polish():
    """The JAX test_inverse_renderer_history_mode and _polish_tail: finite
    losses, the residual kept in history mode, dropped after the polish
    tail (POLISH_STEPS capped at half the fit), re-seeded after."""
    target = np.zeros((RES, RES, 3), np.float32)
    for hist in (True, False):
        ir = PInv.InverseRenderer(_cornell(), target, trace_depth=2, seed=3,
                                  history=hist, device="cpu")
        losses = ir.fit(3, polish_steps=0) if hist else ir.fit(3)
        assert len(losses) == 3 and np.isfinite(losses).all()
        assert (ir.hist is not None) == hist
        if hist:
            assert ir.hist.shape == (RES, RES, 3)
    ir = PInv.InverseRenderer(_cornell(), target, trace_depth=2, seed=3,
                              device="cpu")
    assert ir.polish_steps == PInv.InverseRenderer.POLISH_STEPS
    losses = ir.fit(4)   # 2 history + 2 polish
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert ir.hist is None and int(ir.opt_state.count) == 4
    assert np.isfinite(ir.step()) and ir.hist is not None
