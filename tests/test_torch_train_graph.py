"""The port's train step as a graph body on the CPU: `models/inverse.
TrainGraph`, which on the card replays one captured CUDA graph of a whole
train step (render, loss, autograd.grad, Adam, the history update) for
`make_train_scan` and `InverseRenderer`.

What the graph needs is held here where it can be: the in-place Adam
equals the functional one bit for bit; the step body, driven as the
replays drive it (fixed buffers, the reseeded persistent generator, a
0-dim iteration tensor, the caller's tensors copied in and out, the first
step eager, the capture once, then replays, here through a stand-in for
the capture), equals make_train_step calls with fresh generators bit for
bit, on cornell, a mesh scene under remat and a textured scene; the whole
step makes no host round trip after one eager step (tests/torch_audit.py);
three steps of the body hold against a JAX loop that mirrors the JAX
`make_train_scan`'s step; and nothing captures on the CPU. The replays
themselves are held against the eager steps on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import copy
import dataclasses
import functools
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
from project3_cuda_path_tracer_tpu.scene import types as JT
from project3_cuda_path_tracer_tpu_torch import load_scene
from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
from project3_cuda_path_tracer_tpu_torch.models import optim
from project3_cuda_path_tracer_tpu_torch.ops import texfetch
from test_torch_chunk import _pyramid
from test_torch_inverse import FRAC, RTOL, _leaf_names, _sized
from torch_audit import host_round_trips

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
STEPS = 3
LR = 1e-2

# name -> (scene file or None for the pyramid mesh, resolution, depth)
SCENE_SIZES = {"cornell": ("cornell", 32, 4), "mesh": (None, 32, 3),
               "textured": ("textured_env", 32, 2), "sdf": ("sdf", 32, 2),
               "dispersion": ("dispersion", 32, 2)}


@functools.lru_cache(maxsize=None)
def _loaded(path):
    """A scene file loaded once (textured_env's torus takes its SAH build
    each load); callers take copies."""
    return load_scene(path)


def _port_scene(name, tmp_path, stratified=False):
    file, res, depth = SCENE_SIZES[name]
    scene = (load_scene(_pyramid(tmp_path)) if file is None
             else copy.deepcopy(_loaded(os.path.join(SCENES,
                                                     file + ".txt"))))
    return _sized(scene, res=res, depth=depth, stratified=stratified)


class Setup:
    """A scene's train-step tables (textures fused, as the InverseRenderer
    holds them), its config (`train_config`: remat by the rule), a target
    and a start state (params, Adam state, history) made from one numpy
    seed."""

    def __init__(self, ps, stratified=False):
        self.scene = ps
        self.cfg = dataclasses.replace(PInv.train_config(ps),
                                       stratified=stratified)
        self.tables = (ps.geoms, ps.meshes, texfetch.fuse(ps.textures))
        self.packed = ps.packed_meshes
        w, h = ps.camera.resolution
        rng = np.random.default_rng(5)
        self.target = torch.from_numpy(
            rng.random((h, w, 3), dtype=np.float32) * 0.5)
        self.hist0 = torch.from_numpy(rng.random((h, w, 3),
                                                 dtype=np.float32))

    def start(self):
        p = PInv.params_from_scene(self.scene, "cpu")
        return p, optim.init(PInv.param_leaves(p)), self.hist0.clone()

    def scan(self, history, n=STEPS):
        return PInv.make_train_scan(*self.tables, self.cfg, num_steps=n,
                                    packed_meshes=self.packed,
                                    history=history)

    def eager(self, history, seed, steps, state):
        """make_train_step calls with fresh generators (or, stratified,
        the iterations the scan gives step i: i, or 2i and 2i + 1)."""
        step = PInv.make_train_step(*self.tables, self.cfg,
                                    packed_meshes=self.packed,
                                    history=history)
        p, s, h = state
        losses = []
        for i in range(steps):
            strat = self.cfg.stratified
            gen = None if strat else PInv.step_generator(seed, i, "cpu")
            if history:
                p, s, h, loss = step(p, s, h, gen, self.target,
                                     i if strat else None)
            else:
                p, s, loss = step(p, s, gen, self.target,
                                  (2 * i, 2 * i + 1) if strat
                                  else (None, None))
            losses.append(loss)
        return p, s, h, torch.stack(losses)


class Replayed:
    """A stand-in for a captured graph on the CPU: a replay runs the
    captured function (a CUDA graph needs the card)."""

    def __init__(self, fn, pool=None):
        self.fn, self.replays, self.pool_given = fn, 0, pool
        self.graph = self

    def replay(self):
        self.fn()
        self.replays += 1

    def pool(self):
        return id(self)


@pytest.fixture
def as_replays(monkeypatch):
    """TrainGraphs on CPU tensors driven as on the card: the first step
    eagerly, then the capture (the stand-in, recorded in the yielded
    list) and replays."""
    made = []

    def capture(fn, device, **kwargs):
        made.append(Replayed(fn, kwargs.get("pool")))
        return made[-1]
    monkeypatch.setattr(PInv, "capture_graph", capture)
    monkeypatch.setattr(PInv.TrainGraph, "captures", property(lambda s: True))
    return made


def _same(a_state, b_state):
    """Two (params, opt_state, hist, losses) equal bit for bit."""
    (pa, sa, ha, la), (pb, sb, hb, lb) = a_state, b_state
    assert torch.equal(la, lb)
    assert torch.equal(sa.count, sb.count)
    for x, y in zip(PInv.param_leaves(pa) + sa.mu + sa.nu,
                    PInv.param_leaves(pb) + sb.mu + sb.nu):
        assert torch.equal(x, y)
    assert (ha is None) == (hb is None)
    assert ha is None or torch.equal(ha, hb)


def test_inplace_adam_equals_functional():
    """optim.update_ writes what optim.update returns, bit for bit, over
    3 steps, with None gradients on some leaves (which still move by
    their momentum); `update` leaves the state it was given as it was."""
    rng = np.random.default_rng(1)
    shapes = [(4, 3), (4,), (3,), ()]
    a = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for s in shapes]
    b = [t.clone() for t in a]
    sa, sb = optim.init(a), optim.init(b)
    for k in range(3):
        grads = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 for s in shapes]
        grads[1] = None
        if k == 1:
            grads[3] = None
        given, kept = sa, optim.copy_state(sa)
        sa = optim.update(a, grads, sa, LR)
        optim.update_(b, grads, sb, LR)
        assert int(given.count) == k
        for x, y in zip(given.mu + given.nu, kept.mu + kept.nu):
            assert torch.equal(x, y)
    assert int(sa.count) == int(sb.count) == 3
    for x, y in zip(a + sa.mu + sa.nu, b + sb.mu + sb.nu):
        assert torch.equal(x, y)


BODY_CASES = [("cornell", "generator"), ("cornell", "stratified"),
              ("mesh", "generator"), ("textured", "generator")]


@pytest.mark.parametrize("history", [True, False])
@pytest.mark.parametrize("name,draws", BODY_CASES)
def test_body_driven_as_replays_matches_steps(name, draws, history,
                                              as_replays, tmp_path):
    """make_train_scan driven as on the card (one eager step, the capture,
    replays; a second call replays the same graph with other tensors)
    against make_train_step calls with fresh `step_generator(seed, i)`
    (or the stratified iterations): losses, leaves, mu, nu, count and
    history bit for bit after each call. The mesh scene runs under remat
    (K2's plain traversal), the textured one through P1's plain gather."""
    su = Setup(_port_scene(name, tmp_path), stratified=draws == "stratified")
    assert su.cfg.remat == (name in ("mesh", "textured"))
    scan = su.scan(history)
    want = su.eager(history, 7, STEPS, su.start())
    p, s, h = su.start()
    got = scan(p, s, h, 7, su.target) if history else scan(p, s, 7,
                                                           su.target)
    got = got if history else (got[0], got[1], None, got[2])
    _same(got, want if history else want[:2] + (None, want[3]))
    g = scan.train_graph
    assert len(as_replays) == 1 and g.graph.replays == STEPS - 1
    # the next call, from fresh tensors holding the first call's results,
    # as bench.py's next epoch: replays alone
    want2 = su.eager(history, 8, STEPS, PInv.copy_train_state(*want[:3]))
    nxt = PInv.copy_train_state(*got[:3])
    got2 = (scan(*nxt, 8, su.target) if history
            else scan(nxt[0], nxt[1], 8, su.target))
    got2 = got2 if history else (got2[0], got2[1], None, got2[2])
    _same(got2, want2 if history else want2[:2] + (None, want2[3]))
    assert len(as_replays) == 1 and g.graph.replays == 2 * STEPS - 1


def test_inverse_renderer_driven_as_replays(as_replays, tmp_path):
    """InverseRenderer driven as on the card: the history and polish
    steps each run one eager step, then the capture, then replays; the
    second capture takes the first one's pool; fit(6, polish_steps=2)
    and then history, polish and history steps again (each graph replayed
    after the other's) equal the eager loop of make_train_step calls on
    InverseRenderer's draw schedule, bit for bit, losses included."""
    ps = _port_scene("cornell", tmp_path)
    target = np.random.default_rng(2).random((32, 32, 3), np.float32) * .5
    ir = PInv.InverseRenderer(ps, target, seed=4, device="cpu")
    losses = ir.fit(6, polish_steps=2)
    losses += [ir.step(), ir.step(polish=True), ir.step()]
    kinds = "hhhhpphph"

    ref = PInv.InverseRenderer(ps, target, seed=4, device="cpu")
    hstep = PInv.make_train_step(*ref.tables, ref.cfg, history=True)
    pstep = PInv.make_train_step(*ref.tables, ref.cfg)
    seed_hist = PInv.make_seed_history(*ref.tables, ref.cfg)
    p, s, hist, draws, want = ref.params, ref.opt_state, None, 0, []
    for kind in kinds:
        if kind == "h" and hist is None:
            hist = seed_hist(p, PInv.step_generator(4, draws, "cpu"))
            draws += 1
        gen = PInv.step_generator(4, draws, "cpu")
        draws += 1
        if kind == "h":
            p, s, hist, loss = hstep(p, s, hist, gen, ref.target)
        else:
            p, s, loss = pstep(p, s, gen, ref.target)
            hist = None
        want.append(float(loss))
    assert losses == want and ir.draws == draws
    _same((ir.params, ir.opt_state, ir.hist, torch.zeros(1)),
          (p, s, hist, torch.zeros(1)))
    hg, pg = ir.train_graph(True), ir.train_graph(False)
    assert len(as_replays) == 2
    assert hg.graph.replays == 5 and pg.graph.replays == 2
    assert as_replays[0].pool_given is None
    assert as_replays[1].pool_given == as_replays[0].pool()


AUDIT_CASES = [("cornell", True), ("cornell", False), ("mesh", True),
               ("textured", True), ("sdf", True), ("dispersion", True)]


@pytest.mark.parametrize("name,history", AUDIT_CASES)
def test_train_step_makes_no_host_round_trip(name, history, monkeypatch,
                                             tmp_path):
    """After one eager step, the whole step (forward, autograd.grad with
    remat's recompute on the mesh and SDF scenes, Adam, the history
    update) reads no device value on the host, gathers by no mask and
    makes no tensor of host data for the device: a capture would fail on
    any (tests/torch_audit.py)."""
    su = Setup(_port_scene(name, tmp_path))
    assert su.cfg.remat == (name in ("mesh", "textured", "sdf"))
    g = PInv.TrainGraph(
        PInv.train_body(*su.tables, su.cfg, packed_meshes=su.packed,
                        history=history),
        history, False, torch.device("cpu"))
    p, s, h = su.start()
    g.load(p, s, h if history else None, su.target)
    g.step(3, 0)
    with host_round_trips(monkeypatch) as audit:
        g._prepare(3, 1)
        with audit:
            g._run()
    assert audit.hits == [] and audit.copies == []
    assert int(g.opt_state.count) == 2 and torch.isfinite(g.loss)


def _jax_pair(name):
    file, res, depth = SCENE_SIZES[name]
    path = os.path.join(SCENES, file + ".txt")
    return (_sized(jax_load_scene(path), res=res, depth=depth),
            _sized(copy.deepcopy(_loaded(path)), res=res, depth=depth))


@pytest.mark.parametrize("name", ["cornell", "textured"])
def test_slice_matches_jax(name, monkeypatch):
    """Three history steps of the port's body (stratified draws, step i at
    iteration i) against a JAX loop that mirrors the JAX
    make_train_scan's step: `render_radiance(..., iteration=i)`, the
    history loss, optax.adam(1e-2), the EMA (decay 0). Both start from
    one numpy target and residual.

    Lanes may diverge at decision thresholds (the lane contract, at most
    FRAC of them): before each step both images are rendered at the
    step's parameters, and the residual is set to the target on the lanes
    that diverge there or diverged in the step before (whose render is
    this step's residual), in both loops: those lanes carry no weight.
    Then each step's loss and every leaf's gradient agree to RTOL. After
    three steps the parameters agree within 3 * lr * RTOL (an Adam step
    moves a leaf by lr * mu_hat / sqrt(nu_hat), which gradients within
    RTOL move by about lr * RTOL), the moments to RTOL (nu, a square, to
    2 * RTOL). An entry whose gradient is non-zero but below the
    gradients' atol (1e-7) in some step takes an Adam step of about lr
    whose sign that noise decides: such entries are held by their
    gradients alone."""
    js, ps = _jax_pair(name)
    mesh = bool((np.asarray(js.geoms.type) == JT.MESH).any())
    jcfg = dataclasses.replace(JI.build_trace_config(js, js.settings),
                               differentiable_mesh=mesh)
    su = Setup(ps, stratified=True)
    su.cfg = dataclasses.replace(su.cfg, dof=bool(jcfg.dof),
                                 motion=bool(jcfg.motion))
    target = su.target.numpy()

    def loss(p, hist, it):
        img = JI.render_radiance(p.materials, p.cam, js.geoms, js.meshes,
                                 js.textures, jax.random.PRNGKey(0), jcfg,
                                 packed_meshes=js.packed_meshes,
                                 iteration=it)
        return 2.0 * jnp.mean((hist - target) * img), img
    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    opt = optax.adam(LR)
    jparams = JInv.RenderParams(materials=js.materials, cam=js.camera.flat())
    jstate = opt.init(jparams)
    jhist = jnp.asarray(su.hist0.numpy())
    beta = jnp.float32(PInv.HISTORY_DECAY)

    got_grads = []
    real = optim.update_

    def spy(leaves, grads, *args, **kwargs):
        got_grads.append([None if x is None else x.clone() for x in grads])
        return real(leaves, grads, *args, **kwargs)
    monkeypatch.setattr(optim, "update_", spy)
    g = PInv.TrainGraph(
        PInv.train_body(*su.tables, su.cfg, packed_meshes=su.packed,
                        history=True), True, True, torch.device("cpu"))
    g.load(*su.start(), su.target)
    names = _leaf_names(jparams)
    before = np.zeros(target.shape[:2], bool)
    noise = [np.zeros(np.shape(a), bool)
             for a in jax.tree_util.tree_leaves(jparams)]
    for i in range(STEPS):
        it = jnp.int32(i)
        (_, jimg), _ = vg(jparams, jhist, it)
        with torch.no_grad():
            pimg = PInv.render_image(g.params, *su.tables, None, su.cfg,
                                     su.packed, iteration=i).numpy()
        diverged = (np.abs(pimg - np.asarray(jimg)) > 1e-4).any(axis=-1)
        assert diverged.mean() <= FRAC, f"{diverged.sum()} lanes diverge"
        mask = diverged | before
        before = diverged
        jhist = jnp.where(mask[..., None], target, jhist)
        g.hist.copy_(torch.where(torch.from_numpy(mask)[..., None],
                                 su.target, g.hist))
        (jloss, jimg), jgrads = vg(jparams, jhist, it)
        upd, jstate = opt.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        jhist = beta * jhist + (1.0 - beta) * jax.lax.stop_gradient(jimg)
        g.step(0, i)
        np.testing.assert_allclose(float(g.loss), float(jloss), rtol=RTOL)
        for k, (what, want, got) in enumerate(zip(
                names, jax.tree_util.tree_leaves(jgrads), got_grads[i])):
            want = np.asarray(want)
            got = np.zeros_like(want) if got is None else got.numpy()
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7,
                                       err_msg=f"step {i} {what}")
            noise[k] |= (want != 0) & (np.abs(want) < 1e-7)
    jmu, jnu = jstate[0].mu, jstate[0].nu
    assert int(g.opt_state.count) == int(jstate[0].count) == STEPS
    for what, keep, pw, pg, mw, mg, vw, vgot in zip(
            names, noise, jax.tree_util.tree_leaves(jparams),
            PInv.param_leaves(g.params), jax.tree_util.tree_leaves(jmu),
            g.opt_state.mu, jax.tree_util.tree_leaves(jnu),
            g.opt_state.nu):
        keep = ~keep
        np.testing.assert_allclose(pg.detach().numpy()[keep],
                                   np.asarray(pw)[keep], rtol=0,
                                   atol=3 * LR * RTOL, err_msg=what)
        np.testing.assert_allclose(mg.numpy()[keep], np.asarray(mw)[keep],
                                   rtol=RTOL, atol=1e-9, err_msg=what)
        np.testing.assert_allclose(vgot.numpy()[keep], np.asarray(vw)[keep],
                                   rtol=2 * RTOL, atol=1e-12, err_msg=what)
    moved = [float(np.abs(np.asarray(a) - b.detach().numpy()).max())
             for a, b in zip(jax.tree_util.tree_leaves(jparams),
                             PInv.param_leaves(PInv.params_from_scene(
                                 ps, "cpu")))]
    assert max(moved) > LR


def test_cpu_never_captures(monkeypatch):
    """On CPU tensors make_train_scan (both forms) and InverseRenderer run
    the body eagerly: nothing is captured."""
    def refuse(*args, **kwargs):
        raise AssertionError("captured on the CPU")
    monkeypatch.setattr(PInv, "capture_graph", refuse)
    su = Setup(_port_scene("cornell", None))
    for history in (True, False):
        scan = su.scan(history, n=2)
        p, s, h = su.start()
        out = scan(p, s, h, 1, su.target) if history else scan(p, s, 1,
                                                               su.target)
        assert torch.isfinite(out[-1]).all()
        assert not scan.train_graph.captures
        assert scan.train_graph.graph is None
    ir = PInv.InverseRenderer(su.scene, su.target.numpy(), device="cpu")
    assert np.isfinite(ir.fit(3, polish_steps=1)).all()
    assert all(ir.train_graph(h).graph is None for h in (True, False))
