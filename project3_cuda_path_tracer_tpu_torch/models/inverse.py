"""Differentiable (inverse) rendering: the fwd+bwd train step in autograd.

Counterpart of project3_cuda_path_tracer_tpu/models/inverse.py, function for
function. The forward is `render.integrator.render_radiance` over the torch
wavefront stages (ops/wavefront.py), which detach every discrete decision
(lobe and Fresnel choice, the diffuse direction, the winning triangle), so
autograd of a pixel loss is the detached-sampling gradient the JAX package
takes with `jax.grad`. The hand kernels carry no gradient and need none: on
mesh scenes the BVH traversal (kernel K2) picks the triangle inside the
step and the hit is recomputed in torch ops (`TraceConfig.
differentiable_mesh`).

Draws: where a JAX function takes a PRNG key, these take a
`torch.Generator` in its place (None is the global stream), and every one
also accepts a stratified `iteration` (with `cfg.stratified`) that pins its
draws to the lattice both packages share, so the tests can hold the
gradients against jax.grad.

A parameter is frozen with `requires_grad_(False)`: it then takes a zero
gradient, which leaves it in place (the counterpart of optax.masked over a
fresh optimizer state).

On the card `make_train_scan` and `InverseRenderer` replay one captured
CUDA graph of a whole train step (`TrainGraph`: render, loss,
`torch.autograd.grad` through the wavefront stages, Adam, the history
update), bit for bit the eager steps; the counterpart of the JAX package's
jitted step and scanned loop. The CPU runs the same body eagerly.

The memory schedule: `train_config` takes the JAX InverseRenderer's remat
rule (mesh scenes, and traces above 800x800 at depth 8) and adds SDF
scenes; under `TraceConfig.remat` each bounce runs under
torch.utils.checkpoint, so the backward pass keeps one bounce's saved
tensors at a time. Not ported, by decision: `_bake_static_tables` and the
unroll choice, XLA compile knobs.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import optim
from ..ops import megakernel as mk
from ..ops import texfetch
from ..render import integrator as integ
from ..scene import types as T
from ..utils.device import CapturedGraph, capture_graph, resolve_device
from ..utils.launches import launch_counts
from ..utils.profiling import span


class RenderParams(NamedTuple):
    """The differentiable parameters: material table + camera."""
    materials: T.Materials
    cam: dict  # Camera.flat()


def _map_params(fn, materials: T.Materials, cam: dict) -> RenderParams:
    """RenderParams of `fn` applied to every tensor of a material table and
    a camera dict (a None field stays None)."""
    mats = {f.name: getattr(materials, f.name)
            for f in dataclasses.fields(materials)}
    return RenderParams(
        materials=T.Materials(**{k: None if v is None else fn(v)
                                 for k, v in mats.items()}),
        cam={k: fn(v) for k, v in cam.items()})


def params_from_scene(scene: T.Scene, device) -> RenderParams:
    """RenderParams of leaf tensors that require grad, cloned from the
    scene's tables onto `device` (the scene's own tables stay as they
    are)."""
    return _map_params(
        lambda t: (torch.as_tensor(t, dtype=torch.float32).detach()
                   .to(device).clone().requires_grad_(True)),
        scene.materials, scene.camera.flat())


def copy_train_state(params: RenderParams, opt_state: optim.AdamState,
                     hist: Optional[torch.Tensor] = None) -> tuple:
    """(params, opt_state, hist) in new tensors: the leaves detached, each
    keeping whether it requires grad; a None history stays None."""
    return (_map_params(lambda t: t.detach().clone()
                        .requires_grad_(t.requires_grad),
                        params.materials, params.cam),
            optim.copy_state(opt_state),
            None if hist is None else hist.clone())


def param_leaves(params: RenderParams) -> List[torch.Tensor]:
    """The leaves in jax.tree_util.tree_leaves order: the material fields
    as declared (None skipped), then the camera keys sorted."""
    mats = [getattr(params.materials, f.name)
            for f in dataclasses.fields(params.materials)]
    return ([t for t in mats if t is not None]
            + [params.cam[k] for k in sorted(params.cam)])


def render_image(params: RenderParams, geoms, meshes, textures, generator,
                 cfg: integ.TraceConfig, packed_meshes=(),
                 iteration=None) -> torch.Tensor:
    """One-iteration radiance estimate [H,W,3], differentiable in params."""
    return integ.render_radiance(params.materials, params.cam, geoms,
                                 textures, cfg, generator=generator,
                                 iteration=iteration,
                                 packed_meshes=packed_meshes, meshes=meshes)


def mse_loss(params: RenderParams, geoms, meshes, textures, generator, cfg,
             target: torch.Tensor, packed_meshes=(),
             iteration=None) -> torch.Tensor:
    img = render_image(params, geoms, meshes, textures, generator, cfg,
                       packed_meshes, iteration)
    return torch.mean((img - target) ** 2)


def unbiased_mse_grad_loss(params: RenderParams, geoms, meshes, textures,
                           generator, cfg, target: torch.Tensor,
                           packed_meshes=(),
                           iterations: Sequence = (None, None)
                           ) -> torch.Tensor:
    """Surrogate loss whose gradient is an unbiased estimator of
    d/dθ (E[L] - target)²: the residual comes from one render, detached,
    and the differential from an independent second one (the JAX version's
    two split keys). Both draw from `generator` in turn, the residual's
    first, or from the lattice at `iterations` = (residual's, differential's).
    """
    with torch.no_grad():
        primal = render_image(params, geoms, meshes, textures, generator,
                              cfg, packed_meshes, iterations[0])
    diff = render_image(params, geoms, meshes, textures, generator, cfg,
                        packed_meshes, iterations[1])
    return 2.0 * torch.mean((primal - target) * diff)


# Default EMA decay for the history residual: 0.0 = the residual is the
# previous step's detached render. The JAX package measured every decay
# above 0 unstable in its albedo fit (models/inverse.py HISTORY_DECAY).
HISTORY_DECAY = 0.0


def history_residual_grad_loss(params, geoms, meshes, textures, generator,
                               cfg, target: torch.Tensor,
                               residual: torch.Tensor, packed_meshes=(),
                               iteration=None):
    """One-render surrogate loss: the detached residual factor of
    `unbiased_mse_grad_loss` is the caller's (the training loop's history
    of past renders), so a step renders once. Sound as long as the residual
    is detached and independent of this render; it lags by one step.
    Returns (loss, image): the caller folds the detached image into its
    history."""
    diff = render_image(params, geoms, meshes, textures, generator, cfg,
                        packed_meshes, iteration)
    return 2.0 * torch.mean((residual.detach() - target) * diff), diff


def make_seed_history(geoms, meshes, textures, cfg: integ.TraceConfig,
                      packed_meshes=()):
    """(params, generator, iteration=None) -> detached [H,W,3] render that
    seeds the history residual (one forward pass, run once before
    training)."""
    def seed(params: RenderParams, generator, iteration=None):
        with torch.no_grad():
            return render_image(params, geoms, meshes, textures, generator,
                                cfg, packed_meshes, iteration)
    return seed


def _grads(loss: torch.Tensor, leaves: Sequence[torch.Tensor]):
    """d loss / d leaf for the leaves that require grad; None for the
    others and for leaves the loss does not reach."""
    live = [i for i, p in enumerate(leaves) if p.requires_grad]
    got = torch.autograd.grad(loss, [leaves[i] for i in live],
                              allow_unused=True)
    out = [None] * len(leaves)
    for i, g in zip(live, got):
        out[i] = g
    return out


def train_body(geoms, meshes, textures, cfg: integ.TraceConfig,
               learning_rate: float = 1e-2, unbiased: bool = True,
               packed_meshes=(), history: bool = False,
               history_decay: float = HISTORY_DECAY):
    """One train step that writes its state in place: the body that
    `make_train_step` runs on copies and a `TrainGraph` captures.

    (params, opt_state, hist, generator, target, iterations=(None, None))
    -> the detached 0-dim loss. The parameter leaves and `opt_state` are
    updated by Adam (`optim.update_`), and in the history form `hist` by
    its EMA (`copy_`); `hist` is None in the two-render form. `iterations`
    are the stratified iterations (the history render's, or the
    residual's and the differential's; with `unbiased=False` the MSE
    render's first), None to draw from `generator`."""
    beta = float(history_decay)

    def body(params: RenderParams, opt_state: optim.AdamState, hist,
             generator, target, iterations=(None, None)) -> torch.Tensor:
        if history:
            loss, img = history_residual_grad_loss(
                params, geoms, meshes, textures, generator, cfg, target,
                hist, packed_meshes, iterations[0])
        elif unbiased:
            loss = unbiased_mse_grad_loss(params, geoms, meshes, textures,
                                          generator, cfg, target,
                                          packed_meshes, iterations)
        else:
            loss = mse_loss(params, geoms, meshes, textures, generator, cfg,
                            target, packed_meshes, iterations[0])
        leaves = param_leaves(params)
        optim.update_(leaves, _grads(loss, leaves), opt_state,
                      learning_rate)
        if history:
            hist.copy_(beta * hist + (1.0 - beta) * img.detach())
        return loss.detach()
    return body


def make_train_step(geoms, meshes, textures, cfg: integ.TraceConfig,
                    learning_rate: float = 1e-2, unbiased: bool = True,
                    packed_meshes=(), history: bool = False,
                    history_decay: float = HISTORY_DECAY):
    """A train step: render, loss, backward, then Adam (models/optim.py,
    `optax.adam(learning_rate)`), which updates the parameters in place.

    (params, opt_state, generator, target, iterations=(None, None)) ->
    (params, opt_state, loss) for the two-render form (`unbiased`, else
    the plain MSE at `iterations[0]`); with `history`,
    (params, opt_state, hist, generator, target, iteration=None) ->
    (params, opt_state, hist, loss), where `hist` is the residual image
    (seed it with make_seed_history). `opt_state` is `optim.init` of
    `param_leaves(params)`; the one passed in, and `hist`, stay as they
    were (`train_body` runs on copies of them). The loss comes back as a
    detached 0-dim tensor on the parameters' device (no host sync)."""
    body = train_body(geoms, meshes, textures, cfg, learning_rate, unbiased,
                      packed_meshes, history, history_decay)

    if history:
        def hstep(params: RenderParams, opt_state, hist, generator, target,
                  iteration=None):
            opt_state, hist = optim.copy_state(opt_state), hist.clone()
            loss = body(params, opt_state, hist, generator, target,
                        (iteration, None))
            return params, opt_state, hist, loss
        return hstep

    def step(params: RenderParams, opt_state, generator, target,
             iterations=(None, None)):
        opt_state = optim.copy_state(opt_state)
        loss = body(params, opt_state, None, generator, target, iterations)
        return params, opt_state, loss
    return step


def step_generator(seed: int, i: int, device) -> torch.Generator:
    """The draws of step i of a run seeded `seed` (the counterpart of
    jax.random.fold_in(key, i)): a generator seeded with
    megakernel.seed32(seed, i)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(mk.seed32(seed, i))
    return gen


class TrainGraph:
    """A train step (`train_body`) over fixed buffers, replayed on the card
    as one captured CUDA graph of the whole step: the train path's
    counterpart of `render.integrator.render_chunk`, which
    `make_train_scan` and `InverseRenderer` drive.

    The buffers: the parameter leaves, the Adam state, the history image
    (the history form), the target and the 0-dim `loss`. The draws come
    from one persistent generator, reseeded with `megakernel.seed32(seed,
    i)` before step i, so that it draws what `step_generator(seed, i)`
    draws (the two-render form draws its residual and then its
    differential from it); under `stratified` the step reads its iteration
    from the 0-dim `it_t`: step i renders at iteration i (the two-render
    form at 2i and 2i + 1).

    `step(seed, i)` on the card: the first step runs eagerly (it builds
    the lazy tables, the kernels' libraries and launch plans and
    autograd's device threads), the next one is captured
    (`utils.device.capture_graph`, the generator registered) and replayed,
    and every later one is a replay: bit for bit the eager steps. A
    capture or replay that fails raises; nothing falls back to the eager
    step. On the CPU every step runs the body eagerly. A change of which
    leaves require grad starts over (an eager step, then a new capture).
    `share`, another TrainGraph (an InverseRenderer's history and polish
    steps), lends its pool to whichever of the two captures second:
    neither leaves a live tensor in its pool (every output is written into
    a buffer made before the capture) and they never replay at once.
    `graph` is the capture (`CapturedGraph`), or None."""

    def __init__(self, body, history: bool, stratified: bool,
                 device: torch.device):
        self.body = body
        self.history = history
        self.stratified = stratified
        self.device = device
        self.share: Optional["TrainGraph"] = None
        self.generator = torch.Generator(device=device)
        self.it_t = torch.zeros((), dtype=torch.int64, device=device)
        self.loss = torch.zeros((), dtype=torch.float32, device=device)
        self.params: Optional[RenderParams] = None
        self.opt_state: Optional[optim.AdamState] = None
        self.hist: Optional[torch.Tensor] = None
        self.target: Optional[torch.Tensor] = None
        self.graph: Optional[CapturedGraph] = None
        self._flags = None
        self._warm = False

    def bind(self, params: RenderParams, opt_state: optim.AdamState, hist,
             target: torch.Tensor) -> None:
        """Take the caller's own tensors as the buffers (an
        InverseRenderer's, which it keeps for its life)."""
        self.params, self.opt_state = params, opt_state
        self.hist, self.target = hist, target

    @torch.no_grad()
    def load(self, params: RenderParams, opt_state: optim.AdamState, hist,
             target: torch.Tensor) -> None:
        """Copy the caller's tensors into the buffers (made as copies at the
        first call), so that any tensors of the same shapes replay the same
        graph."""
        if self.params is None:
            self.bind(*copy_train_state(params, opt_state, hist),
                      target.clone())
            return
        pairs = list(zip(param_leaves(self.params), param_leaves(params)))
        pairs += [(self.opt_state.count, opt_state.count), (self.target,
                                                            target)]
        pairs += list(zip(self.opt_state.mu + self.opt_state.nu,
                          opt_state.mu + opt_state.nu))
        if hist is not None:
            pairs.append((self.hist, hist))
        for buf, t in pairs:
            buf.copy_(t)
        for buf, t in zip(param_leaves(self.params), param_leaves(params)):
            buf.requires_grad_(t.requires_grad)

    @torch.no_grad()
    def unload(self, params: RenderParams):
        """The buffers' state out to the caller: its leaves overwritten in
        place (as the eager step's Adam does), with copies of the Adam state
        and of the history (the span `train.unload`). Returns (params,
        opt_state, hist)."""
        with span("train.unload"):
            for t, buf in zip(param_leaves(params),
                              param_leaves(self.params)):
                t.copy_(buf)
            return (params, optim.copy_state(self.opt_state),
                    None if self.hist is None else self.hist.clone())

    @property
    def captures(self) -> bool:
        """Whether steps replay a captured graph: on the card."""
        return self.device.type == "cuda"

    def step(self, seed: int, i: int) -> None:
        """Step i of a run seeded `seed` on the buffers; its loss lands in
        `loss`. Where `captures`, an eager step, the capture or a replay
        (class docstring); else the body, eagerly."""
        self._prepare(seed, i)
        if self.captures:
            self._replay()
        else:
            self._run()

    def _prepare(self, seed: int, i: int) -> None:
        """The host's part of step i: a new capture after a change of which
        leaves require grad, the generator reseeded, the iteration into
        `it_t` (the span `train.prepare`)."""
        with span("train.prepare"):
            flags = tuple(p.requires_grad for p in param_leaves(self.params))
            if flags != self._flags:
                self._flags, self.graph, self._warm = flags, None, False
            self.generator.manual_seed(mk.seed32(seed, i))
            self.it_t.fill_(i)

    def _run(self) -> None:
        """The body on the buffers: what the graph holds. It makes no host
        round trip."""
        its = (None, None)
        if self.stratified:
            its = ((self.it_t, None) if self.history
                   else (2 * self.it_t, 2 * self.it_t + 1))
        self.loss.copy_(self.body(self.params, self.opt_state, self.hist,
                                  self.generator, self.target, its))
        self._warm = True

    def _replay(self) -> None:
        """The first step eagerly, then the capture of the next, then
        replays."""
        if self.graph is None:
            if not self._warm:
                self._run()
                return
            other = self.share.graph if self.share is not None else None
            self.graph = capture_graph(
                self._run, self.device, generators=[self.generator],
                counters=launch_counts,
                pool=None if other is None else other.graph.pool(),
                name="train")
        self.graph.replay()


class TrainScan:
    """The function `make_train_scan` returns: `num_steps` steps of a
    `TrainGraph` a call, which it keeps across calls (`train_graph`). The
    copy-in is the span `train.load`, each step's host part
    `train.prepare`, a replay `train.replay`, the copy-out
    `train.unload`."""

    def __init__(self, body, num_steps: int, history: bool,
                 stratified: bool):
        self.body, self.num_steps = body, num_steps
        self.history, self.stratified = history, stratified
        self.train_graph: Optional[TrainGraph] = None

    def __call__(self, params: RenderParams, opt_state, *args):
        hist, seed, target = args if self.history else (None, *args)
        g = self.train_graph
        if g is None:
            g = self.train_graph = TrainGraph(self.body, self.history,
                                              self.stratified, target.device)
        elif target.device != g.device:
            raise ValueError(f"this run's graph is on {g.device}, the "
                             f"target on {target.device}")
        with span("train.load"):
            g.load(params, opt_state, hist, target)
        losses = torch.empty((self.num_steps,), dtype=torch.float32,
                             device=g.device)
        for i in range(self.num_steps):
            g.step(seed, i)
            losses[i].copy_(g.loss)
        params, opt_state, hist = g.unload(params)
        if self.history:
            return params, opt_state, hist, losses
        return params, opt_state, losses


def make_train_scan(geoms, meshes, textures, cfg: integ.TraceConfig,
                    num_steps: int, learning_rate: float = 1e-2,
                    unbiased: bool = True, packed_meshes=(),
                    history: bool = False,
                    history_decay: float = HISTORY_DECAY) -> TrainScan:
    """`num_steps` train steps in one call, the counterpart of the JAX
    lax.scan (its "production training-loop form"): step i draws from
    `step_generator(seed, i)` (under `cfg.stratified` it renders at
    iteration i, the two-render form at 2i and 2i + 1), bit for bit the
    loop of make_train_step calls. On the card every step but the first a
    run ever takes is a replay of one captured CUDA graph of the step
    (`TrainGraph`); the graph belongs to the returned function, so a later
    call replays it without a new capture. The caller's tensors are copied
    into the graph's buffers at a call's start and out at its end (its
    leaves in place, new Adam state and history), and the losses come back
    as a device tensor: no host sync inside a call. On the CPU the steps
    run eagerly.

    (params, opt_state, seed, target) -> (params, opt_state, losses
    [num_steps]); with `history`, (params, opt_state, hist, seed, target)
    -> (params, opt_state, hist, losses)."""
    body = train_body(geoms, meshes, textures, cfg, learning_rate, unbiased,
                      packed_meshes, history, history_decay)
    return TrainScan(body, num_steps, history, cfg.stratified)


def train_state_gap(a, b) -> dict:
    """How far apart two train states (params, opt_state, hist, losses)
    are, by part ("losses", "params", "mu", "nu", "count", "hist"): 0.0
    where the part is equal, else its largest absolute
    difference (inf where either holds a NaN there). Equal means
    `torch.equal`, as `integrator.same_state` has it. `hist` may be None
    in both."""
    def gap(xs, ys):
        worst = 0.0
        for x, y in zip(xs, ys):
            if torch.equal(x, y):
                continue
            d = (x.detach().double() - y.detach().double()).abs()
            worst = max(worst, float(torch.nan_to_num(d, nan=float("inf"))
                                     .max()))
        return worst
    (pa, sa, ha, la), (pb, sb, hb, lb) = a, b
    return dict(losses=gap([la], [lb]),
                params=gap(param_leaves(pa), param_leaves(pb)),
                mu=gap(sa.mu, sb.mu), nu=gap(sa.nu, sb.nu),
                count=gap([sa.count], [sb.count]),
                hist=0.0 if ha is None and hb is None else gap([ha], [hb]))


# The JAX InverseRenderer's schedule rule: a trace keeps every bounce's
# residuals up to this many lane-bounces (800x800, depth 8) on scenes
# without meshes; mesh scenes and larger traces recompute each bounce in
# the backward pass (TraceConfig.remat). The port adds SDF scenes: its
# eager march saves each of its 64 steps' planes, and sdf.txt's step at
# 800x800 depth 8 runs out of an 80 GB H100 without remat (PERF.md).
REMAT_LANE_BOUNCES = 800 * 800 * 8


def train_config(scene: T.Scene, trace_depth: Optional[int] = None,
                 remat: Optional[bool] = None) -> integ.TraceConfig:
    """The train step's TraceConfig: the forward Renderer's scene-derived
    fields (`integ.build_trace_config`: textures, bump and normal maps,
    the sky, SDF kinds, dispersion, the filtering mode), with the draws
    of the JAX train step (pseudo-random, the lens and shutter chains
    always on so that their leaves take gradients), mesh hits recomputed
    differentiably, and none of the render-only knobs (sort, compaction,
    roulette, the clamp, NEE, adaptive sampling). `remat` defaults to
    the rule of REMAT_LANE_BOUNCES."""
    fwd = integ.build_trace_config(scene, scene.settings)
    w, h = scene.camera.resolution
    depth = trace_depth or scene.settings.trace_depth
    has_mesh = T.MESH in fwd.geom_types
    if remat is None:
        remat = (has_mesh or bool(fwd.sdf_kinds)
                 or w * h * depth > REMAT_LANE_BOUNCES)
    return integ.TraceConfig(
        width=w, height=h, trace_depth=depth,
        antialias=scene.settings.antialias, geom_types=fwd.geom_types,
        mesh_ids=fwd.mesh_ids, differentiable_mesh=has_mesh,
        glossy=fwd.glossy, sky=fwd.sky, bump=fwd.bump, nmap=fwd.nmap,
        bilinear=fwd.bilinear, bilinear_fast=fwd.bilinear_fast,
        sdf_kinds=fwd.sdf_kinds, dispersion=fwd.dispersion,
        remat=bool(remat))


class InverseRenderer:
    """Fit scene parameters to a target image by gradient descent (the JAX
    InverseRenderer).

    ``history=True`` (default) runs the one-render history-residual step;
    its one-step-stale residual shifts the fit's equilibrium by about one
    Adam step of drift at a constant learning rate, so ``fit(steps)`` ends
    with ``polish_steps`` two-render unbiased steps on the same optimizer
    state (default POLISH_STEPS, capped at half the fit). It trains through
    every scene the forward Renderer draws (`train_config`): mesh hits are
    recomputed differentiably, and textures, checkers, bump and normal
    maps, the env map, the sky, SDF geoms and dispersion carry their
    gradients. `remat` overrides the memory schedule's rule
    (`train_config`). `device` is "cuda" or "cpu" and is never chosen for
    the caller. On the card each form's steps replay one captured graph of
    the whole step (`train_graph`); its buffers are the renderer's own
    `params`, `opt_state`, history image and `target`, updated in place.
    `step` returns the loss as a float, as the JAX `step` does."""

    # Adam's momentum horizon is 1/(1-b1) = 10 steps; three times that
    # replaces the stale history equilibrium with the unbiased one.
    POLISH_STEPS = 30

    def __init__(self, scene: T.Scene, target, spp_per_step: int = 1,
                 learning_rate: float = 1e-2,
                 trace_depth: Optional[int] = None, seed: int = 0,
                 history: bool = True, polish_steps: Optional[int] = None,
                 device: str = "cuda", remat: Optional[bool] = None):
        self.device = resolve_device(device)
        dev = self.device
        self.cfg = train_config(scene, trace_depth, remat)
        self.scene = scene
        self.target = torch.as_tensor(np.asarray(target, np.float32),
                                      device=dev)
        self.params = params_from_scene(scene, dev)
        self.history = history
        self.polish_steps = (self.POLISH_STEPS if polish_steps is None
                             else int(polish_steps)) if history else 0
        self.learning_rate = learning_rate
        self.tables = (integ.to_device(scene.geoms, dev),
                       integ.to_device(scene.meshes, dev),
                       texfetch.fuse(integ.to_device(scene.textures, dev)))
        self.packed_meshes = tuple(integ.to_device(p, dev)
                                   for p in scene.packed_meshes)
        self.opt_state = optim.init(param_leaves(self.params))
        self.seed = seed
        self.draws = 0
        self.spp = spp_per_step
        self.hist = None
        # the history image's one buffer (`hist` while it is seeded)
        self._hist_buf = torch.zeros_like(self.target) if history else None
        self._graphs = {}  # history form? -> its TrainGraph
        if history:
            self._seed_hist = make_seed_history(
                *self.tables, self.cfg, packed_meshes=self.packed_meshes)

    def _generator(self) -> torch.Generator:
        """Every render draws from its own generator: the JAX key split."""
        gen = step_generator(self.seed, self.draws, self.device)
        self.draws += 1
        return gen

    def train_graph(self, history: bool) -> TrainGraph:
        """The history (or two-render) step's TrainGraph over this
        renderer's own tensors (its leaves, Adam state, history buffer and
        target), made at first use. The two share the optimizer state and
        one graph pool (`TrainGraph.share`)."""
        g = self._graphs.get(history)
        if g is None:
            body = train_body(*self.tables, self.cfg, self.learning_rate,
                              packed_meshes=self.packed_meshes,
                              history=history)
            g = self._graphs[history] = TrainGraph(
                body, history, self.cfg.stratified, self.device)
            g.bind(self.params, self.opt_state,
                   self._hist_buf if history else None, self.target)
            g.share = self._graphs.get(not history)
            if g.share is not None:
                g.share.share = g
        return g

    def seed_history(self) -> None:
        """Seed the residual with one detached render, into the history
        buffer (a history step does it where `hist` is None): the first
        history step is then exactly the two-render unbiased loss."""
        self.hist = self._hist_buf.copy_(
            self._seed_hist(self.params, self._generator()))

    @property
    def graphs(self) -> dict:
        """The captured steps by form ("history", "two_render"): each a
        `CapturedGraph` (launches, capture and instantiate seconds, pool
        bytes, replays), or None before its capture."""
        return {("history" if h else "two_render"): g.graph
                for h, g in self._graphs.items()}

    def step(self, polish: bool = False) -> float:
        """One optimizer step (per `spp_per_step`). ``polish=True`` forces
        the two-render unbiased loss; the optimizer state is shared between
        the two forms. On the card each form's first step runs eagerly and
        the later ones replay its captured graph (`TrainGraph`)."""
        use_hist = self.history and not polish
        if use_hist and self.hist is None:
            self.seed_history()
        g = self.train_graph(use_hist)
        for _ in range(self.spp):
            g.step(self.seed, self.draws)
            self.draws += 1
            if not use_hist:
                # params moved under another loss: a later history step
                # must re-seed
                self.hist = None
        return float(g.loss)

    def fit(self, steps: int, polish_steps: Optional[int] = None) -> list:
        """Run `steps` optimizer steps; under history mode the last
        `polish_steps` (default self.polish_steps, capped at half the fit
        unless given) use the two-render unbiased loss."""
        ps = self.polish_steps if polish_steps is None else int(polish_steps)
        cap = steps if polish_steps is not None else steps // 2
        ps = min(max(ps, 0), cap) if self.history else 0
        losses = [self.step() for _ in range(steps - ps)]
        losses += [self.step(polish=True) for _ in range(ps)]
        return losses
