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
from ..utils.device import resolve_device


class RenderParams(NamedTuple):
    """The differentiable parameters: material table + camera."""
    materials: T.Materials
    cam: dict  # Camera.flat()


def params_from_scene(scene: T.Scene, device) -> RenderParams:
    """RenderParams of leaf tensors that require grad, cloned from the
    scene's tables onto `device` (the scene's own tables stay as they
    are)."""
    def leaf(t):
        return (torch.as_tensor(t, dtype=torch.float32).detach()
                .to(device).clone().requires_grad_(True))
    mats = {f.name: getattr(scene.materials, f.name)
            for f in dataclasses.fields(scene.materials)}
    return RenderParams(
        materials=T.Materials(**{k: None if v is None else leaf(v)
                                 for k, v in mats.items()}),
        cam={k: leaf(v) for k, v in scene.camera.flat().items()})


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
    `param_leaves(params)`. The loss comes back as a detached 0-dim tensor
    on the parameters' device (no host sync)."""
    beta = float(history_decay)

    def apply(params, opt_state, loss):
        leaves = param_leaves(params)
        opt_state = optim.update(leaves, _grads(loss, leaves), opt_state,
                                 learning_rate)
        return opt_state

    if history:
        def hstep(params: RenderParams, opt_state, hist, generator, target,
                  iteration=None):
            loss, img = history_residual_grad_loss(
                params, geoms, meshes, textures, generator, cfg, target,
                hist, packed_meshes, iteration)
            opt_state = apply(params, opt_state, loss)
            hist = beta * hist + (1.0 - beta) * img.detach()
            return params, opt_state, hist, loss.detach()
        return hstep

    def step(params: RenderParams, opt_state, generator, target,
             iterations=(None, None)):
        if unbiased:
            loss = unbiased_mse_grad_loss(params, geoms, meshes, textures,
                                          generator, cfg, target,
                                          packed_meshes, iterations)
        else:
            loss = mse_loss(params, geoms, meshes, textures, generator, cfg,
                            target, packed_meshes, iterations[0])
        opt_state = apply(params, opt_state, loss)
        return params, opt_state, loss.detach()
    return step


def step_generator(seed: int, i: int, device) -> torch.Generator:
    """The draws of step i of a run seeded `seed` (the counterpart of
    jax.random.fold_in(key, i)): a generator seeded with
    megakernel.seed32(seed, i)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(mk.seed32(seed, i))
    return gen


def make_train_scan(geoms, meshes, textures, cfg: integ.TraceConfig,
                    num_steps: int, learning_rate: float = 1e-2,
                    unbiased: bool = True, packed_meshes=(),
                    history: bool = False,
                    history_decay: float = HISTORY_DECAY):
    """`num_steps` train steps in one call (the JAX lax.scan), as a Python
    loop: step i draws from `step_generator(seed, i)`.

    (params, opt_state, seed, target) -> (params, opt_state, losses
    [num_steps]); with `history`, (params, opt_state, hist, seed, target)
    -> (params, opt_state, hist, losses)."""
    step = make_train_step(geoms, meshes, textures, cfg, learning_rate,
                           unbiased, packed_meshes, history, history_decay)

    if history:
        def hrun(params: RenderParams, opt_state, hist, seed: int, target):
            losses = []
            for i in range(num_steps):
                params, opt_state, hist, loss = step(
                    params, opt_state, hist,
                    step_generator(seed, i, target.device), target)
                losses.append(loss)
            return params, opt_state, hist, torch.stack(losses)
        return hrun

    def run(params: RenderParams, opt_state, seed: int, target):
        losses = []
        for i in range(num_steps):
            params, opt_state, loss = step(
                params, opt_state, step_generator(seed, i, target.device),
                target)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)
    return run


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
    the caller."""

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
        self._step = make_train_step(
            *self.tables, self.cfg, learning_rate,
            packed_meshes=self.packed_meshes, history=history)
        self._plain_step = None if history else self._step
        self.opt_state = optim.init(param_leaves(self.params))
        self.seed = seed
        self.draws = 0
        self.spp = spp_per_step
        self.hist = None
        if history:
            self._seed_hist = make_seed_history(
                *self.tables, self.cfg, packed_meshes=self.packed_meshes)

    def _generator(self) -> torch.Generator:
        """Every render draws from its own generator: the JAX key split."""
        gen = step_generator(self.seed, self.draws, self.device)
        self.draws += 1
        return gen

    def _get_plain_step(self):
        """The two-render unbiased step, built at first use; it shares the
        optimizer state with the history step."""
        if self._plain_step is None:
            self._plain_step = make_train_step(
                *self.tables, self.cfg, self.learning_rate,
                packed_meshes=self.packed_meshes, history=False)
        return self._plain_step

    def step(self, polish: bool = False) -> float:
        """One optimizer step (per `spp_per_step`). ``polish=True`` forces
        the two-render unbiased loss; the optimizer state is shared between
        the two forms."""
        loss = None
        use_hist = self.history and not polish
        if use_hist and self.hist is None:
            # seed the residual with one detached render: the first history
            # step is then exactly the two-render unbiased loss
            self.hist = self._seed_hist(self.params, self._generator())
        for _ in range(self.spp):
            if use_hist:
                self.params, self.opt_state, self.hist, loss = self._step(
                    self.params, self.opt_state, self.hist,
                    self._generator(), self.target)
            else:
                self.params, self.opt_state, loss = self._get_plain_step()(
                    self.params, self.opt_state, self._generator(),
                    self.target)
                # params moved under another loss: a later history step
                # must re-seed
                self.hist = None
        return float(loss)

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
