"""Pixel sharding of the render and the train step over torch.distributed.

Counterpart of project3_cuda_path_tracer_tpu/parallel/sharding.py. The
scaling story is the JAX package's: pure data parallelism over pixels.

  * one process a rank, each on its own device; the process group stands
    in for the JAX 1-D `Mesh(devices, ('data',))`;
  * rank r traces a contiguous block of pixel rows, H/world of them, with
    global pixel indices, through the wavefront route
    (`TraceConfig.ray_range`); the height must divide by the world size;
  * the scene tables (KB to MB) are replicated: each rank moves its own
    copy to its device (`shard_scene`);
  * the accumulator stays on each rank's device and is gathered only at
    `image()`, `save()` and a checkpoint;
  * the train step's loss is normalised by the global pixel count and the
    parameter gradients are summed with `all_reduce(SUM)` (GSPMD's psum).

Draws: the stratified ones hash the global pixel index, so they do not
depend on the split. The pseudo-random ones are taken for the whole frame
on every rank and sliced to its rows (`ops.wavefront.rand_planes`): each
rank pays the whole frame's draws (4 planes a bounce, a few ms at 800x800
on the card), and in return a sharded frame equals the single-process
wavefront frame.

The backend is the caller's (`init_distributed`): `nccl` for ranks that
each own a card, `gloo` on the CPU (gloo also carries CUDA tensors). There
is no switch between them. ReSTIR is dropped under sharding with a
`features dropped` line, as in the JAX package (its temporal reservoir
needs the single-process path order).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models import inverse as inv
from ..models import optim
from ..ops import megakernel as mk
from ..ops import texfetch
from ..render import adaptive as A
from ..render import integrator as integ
from ..scene import types as T
from ..utils import image as img_io

BACKENDS = ("nccl", "gloo")

# mixed into the seed of a rank's generator under adaptive sampling (each
# rank traces its own paths there; rank 0 keeps the single-process stream)
RANK_SALT = 0x5348


def init_distributed(backend: str, init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> None:
    """Start the default process group (the JAX `init_distributed`), with
    the backend named by the caller. `init_method` (`tcp://host:port`,
    `file:///path`, `env://`) with `world_size` and `rank`; without it,
    `env://` when the launcher set WORLD_SIZE (torchrun), else a world of
    one on an in-process store."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if dist.is_initialized():
        return
    if init_method is None and "WORLD_SIZE" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank)


def shutdown() -> None:
    """Destroy the default process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_device(backend: str, device: str) -> torch.device:
    """The device this rank renders on: under `cuda`, card LOCAL_RANK
    (or the current one); refuses nccl with the CPU."""
    if device == "cpu":
        if backend == "nccl":
            raise ValueError("nccl needs a card a rank; use gloo on the CPU")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    idx = int(os.environ.get("LOCAL_RANK", torch.cuda.current_device()))
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def row_block(height: int, world: int, rank: int) -> tuple:
    """Rank `rank`'s pixel rows [lo, hi) of a `height`-row frame."""
    if height % world:
        raise ValueError(f"height {height} not divisible by world size "
                         f"{world}; pad the resolution")
    rows = height // world
    return rank * rows, (rank + 1) * rows


def shard_scene(scene: T.Scene, device) -> tuple:
    """The scene's tables replicated onto this rank's `device`:
    ((materials, camera dict, geoms, fused textures), packed meshes,
    triangle bundle)."""
    dev = torch.device(device)
    tables = (integ.to_device(scene.materials, dev), scene.camera.flat(dev),
              integ.to_device(scene.geoms, dev),
              texfetch.fuse(integ.to_device(scene.textures, dev)))
    return (tables, tuple(integ.to_device(p, dev)
                          for p in scene.packed_meshes),
            integ.to_device(scene.meshes, dev))


def gather_rows(local: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' row blocks of equal shape, stacked in rank order into the
    whole frame (every rank gets it)."""
    world = dist.get_world_size(group)
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, dim=0)


class ShardedRenderer(integ.Renderer):
    """Data-parallel progressive renderer over the process group (the JAX
    ShardedRenderer): `integ.Renderer`'s surface (step, step_many,
    render, image, save, reset, checkpoint_extras / restore_extras, and
    adaptive sampling), with the accumulator holding this rank's rows
    only, always through the wavefront route. `image()` and `save()` are
    collective: every rank calls them; rank 0 writes the file.

    Adaptive sampling: each rank's paths stay in its row block
    (`adaptive.plan_epoch_sharded`), the replan gathers the statistics,
    and every rank computes the same plan and takes its block.

    On the card `step_many` replays one captured iteration of the rank's
    rows (`integ.render_chunk`, the JAX `render_chunk_sharded`): a replan
    and its gathers run on the host between replays, so no collective
    runs inside the graph."""

    def __init__(self, scene: T.Scene, group=None,
                 settings: Optional[T.RenderSettings] = None,
                 device: str = "cuda"):
        if not dist.is_initialized():
            raise RuntimeError("call parallel.sharding.init_distributed "
                               "first")
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        w, h = scene.camera.resolution
        self.rows = row_block(h, self.world, self.rank)
        st = settings or scene.settings
        drops = []
        if int(st.restir) >= 1:
            drops.append("restir (single-process only: the temporal "
                         "reservoir needs the identity path order)")
            st = dataclasses.replace(st, restir=0)
        local_device(dist.get_backend(group), device)  # pins the card
        super().__init__(scene, st, device=device, route="wavefront",
                         drops=drops)
        lo, hi = self.rows
        if not self.cfg.adaptive:
            self.cfg = dataclasses.replace(self.cfg,
                                           ray_range=(lo * w, hi * w))
        self.reset()

    def _accum_rows(self) -> tuple:
        """(rows, width) of this rank's accumulator: its row block."""
        lo, hi = self.rows
        return hi - lo, self.scene.camera.resolution[0]

    def _identity_plan(self) -> None:
        """The adaptive warm-up mapping: the per-block identity."""
        w, h = self.scene.camera.resolution
        self._set_full_plan(A.identity_plan_sharded(w, h, self.world))

    def _set_full_plan(self, plan) -> None:
        """Keep the whole frame's plan (for checkpoints) and take this
        rank's block of it into the fixed-size buffers the iteration
        reads."""
        pix, surr, cimg = plan
        self._full_plan = (pix, surr, cimg)
        w = self.scene.camera.resolution[0]
        lo, hi = self.rows
        n = (hi - lo) * w
        sl = slice(self.rank * n, (self.rank + 1) * n)
        self._set_plan((pix[sl], surr[sl], cimg[lo:hi]))

    def _seed_of(self, salt: int) -> int:
        if not self.cfg.adaptive:
            return super()._seed_of(salt)
        return mk.seed32(self.seed ^ salt ^ (RANK_SALT * self.rank),
                         self.iteration)

    def _replan(self) -> None:
        """Every rank gathers the statistics and computes the same plan,
        then takes its block (collective; on the host, between
        iterations)."""
        self._set_full_plan(A.plan_epoch_sharded(
            gather_rows(self.accum, self.group).cpu().numpy(),
            gather_rows(self.accum2, self.group).cpu().numpy(),
            gather_rows(self._count, self.group).cpu().numpy(),
            self.world))
        self._next_replan = self.iteration + self.adaptive_epoch

    def _iterate_adaptive(self, generator, light_gen) -> None:
        """One adaptive iteration over this rank's block of the plan: its
        paths' pixels lie in its rows, so the scatter is local and no
        collective runs (the iteration a graph captures)."""
        pix, surr, count_img = self._plan
        rad, pix = integ.trace_wavefront(
            *self.tables, self.cfg, generator=generator,
            iteration=self._it_t, packed_meshes=self.packed_meshes,
            meshes=self.meshes, light_gen=light_gen, pix_override=pix,
            samp_index=surr)
        local = pix - self.rows[0] * self.cfg.width
        self.accum.view(-1, 3).index_put_(
            (local,), torch.stack(tuple(rad), dim=-1), accumulate=True)
        lum = integ._lum(rad)
        self.accum2.view(-1).index_put_((local,), lum * lum,
                                        accumulate=True)
        self._count.add_(count_img)

    @property
    def count(self) -> np.ndarray:
        """Per-pixel sample counts of the whole frame [H,W] (gathered under
        adaptive sampling; collective)."""
        if not self.cfg.adaptive:
            w, h = self.scene.camera.resolution
            return np.full((h, w), float(self.iteration))
        return gather_rows(self._count, self.group).cpu().numpy()

    def full_accum(self) -> torch.Tensor:
        """The whole frame's accumulator [H,W,3], gathered (collective)."""
        return gather_rows(self.accum, self.group)

    def load_accum(self, accum: np.ndarray) -> None:
        """Take this rank's rows of a whole-frame accumulator (a resumed
        checkpoint's)."""
        lo, hi = self.rows
        self.accum.copy_(torch.from_numpy(np.ascontiguousarray(
            accum[lo:hi])))

    def _full_mean(self) -> torch.Tensor:
        acc = self.full_accum()
        if self.cfg.adaptive:
            cnt = gather_rows(self._count, self.group)
            return acc / torch.clamp(cnt, min=1.0)[..., None]
        return acc / max(self.iteration, 1)

    def image(self) -> np.ndarray:
        """The gathered mean image, x-mirrored (collective)."""
        return self._full_mean().cpu().numpy()[:, ::-1, :]

    def checkpoint_extras(self) -> dict:
        """Adaptive state of the whole frame, gathered (collective); empty
        otherwise."""
        if not self.cfg.adaptive:
            return {}
        pix, surr, cimg = self._full_plan
        return dict(accum2=gather_rows(self.accum2,
                                       self.group).cpu().numpy(),
                    count=self.count, plan_pix=pix.numpy(),
                    plan_surr=surr.numpy(), plan_cimg=np.asarray(cimg),
                    next_replan=np.int64(self._next_replan))

    def restore_extras(self, extras: dict) -> None:
        """The whole frame's adaptive state: this rank's rows of it into
        its buffers, in place."""
        if not self.cfg.adaptive:
            return
        if "accum2" not in extras:
            raise ValueError("checkpoint has no adaptive state; resume "
                             "without --adaptive or re-render")
        lo, hi = self.rows
        f32 = torch.float32
        self.accum2 = self._into(self.accum2, torch.as_tensor(
            extras["accum2"][lo:hi], dtype=f32))
        self._count = self._into(self._count, torch.as_tensor(
            extras["count"][lo:hi], dtype=f32))
        self._set_full_plan((torch.as_tensor(extras["plan_pix"]),
                             torch.as_tensor(extras["plan_surr"]),
                             np.asarray(extras["plan_cimg"], np.float32)))
        self._next_replan = int(extras["next_replan"])

    def denoised_accum(self) -> torch.Tensor:
        """The gathered frame through the à-trous denoiser over the whole
        frame's G-buffer (a save-time pass; collective)."""
        from ..render import denoise as dn
        mean = self._full_mean()
        cfg = dataclasses.replace(self.cfg, ray_range=(), adaptive=False)
        normal, pos, alb = dn.gbuffer(self.scene, cfg, self.packed_meshes,
                                      albedo=True,
                                      relay=self.iteration >= 64,
                                      tables=self.tables)
        return dn.atrous_denoise(mean, normal, pos,
                                 albedo=alb) * max(self.iteration, 1)

    def save(self, path_base: Optional[str] = None, hdr: bool = False,
             denoise: bool = False, gamma: float = 0.0,
             aces: bool = False) -> str:
        """Gather and write the mean image (collective; rank 0 writes).
        Returns the file's path on every rank."""
        base = path_base or self.settings.image_name
        accum = (self.denoised_accum() if denoise
                 else self._full_mean() * max(self.iteration, 1))
        ext = ".hdr" if hdr else ".png"
        if self.rank != 0:
            return base + ext
        return img_io.save_render(base, accum.cpu().numpy(), self.iteration,
                                  hdr=hdr, gamma=gamma, aces=aces)


def history_loss_sharded(params: inv.RenderParams, tables: tuple,
                         cfg: integ.TraceConfig, target: torch.Tensor,
                         residual: torch.Tensor, packed_meshes=(),
                         meshes=None, generator=None, iteration=None):
    """This rank's share of the one-render history-residual loss:
    2 * sum((residual - target) * image) over its rows, divided by the
    global element count H*W*3, so that the ranks' shares sum to the
    single-process loss. `target` and `residual` are the rank's rows;
    `cfg.ray_range` is its path range. Returns (loss share, image rows)."""
    _, _, geoms, textures = tables
    img = integ.to_image(integ.trace_wavefront(
        params.materials, params.cam, geoms, textures, cfg,
        generator=generator, iteration=iteration,
        packed_meshes=packed_meshes, meshes=meshes), cfg)
    total = cfg.width * cfg.height * 3
    loss = 2.0 * torch.sum((residual.detach() - target) * img) / total
    return loss, img


def all_reduce_grads(loss: torch.Tensor, leaves: Sequence[torch.Tensor],
                     group=None):
    """(global loss, gradients summed over the ranks): each rank's
    gradient of its loss share, then `all_reduce(SUM)` of the loss and of
    every gradient (None where the loss does not reach a leaf or the leaf
    is frozen, on every rank alike)."""
    grads = inv._grads(loss, leaves)
    total = loss.detach().clone()
    dist.all_reduce(total, group=group)
    for g in grads:
        if g is not None:
            dist.all_reduce(g, group=group)
    return total, grads


def make_train_step_sharded(scene: T.Scene, device, learning_rate=1e-2,
                            trace_depth: Optional[int] = None, group=None):
    """The history train step over the process group: each rank renders
    its rows (`history_loss_sharded`), the gradients are summed over the
    ranks (`all_reduce_grads`), and every rank applies the same Adam
    update to its replica of the parameters.

    Returns (cfg, step): step(params, opt_state, hist_rows, generator,
    target_rows, iteration=None) -> (params, opt_state, hist_rows, loss)."""
    cfg = inv.train_config(scene, trace_depth)
    w, h = scene.camera.resolution
    lo, hi = row_block(h, dist.get_world_size(group),
                       dist.get_rank(group))
    cfg = dataclasses.replace(cfg, ray_range=(lo * w, hi * w))
    tables, packed, meshes = shard_scene(scene, device)

    def step(params, opt_state, hist, generator, target, iteration=None):
        loss, img = history_loss_sharded(params, tables, cfg, target, hist,
                                         packed, meshes, generator,
                                         iteration)
        leaves = inv.param_leaves(params)
        total, grads = all_reduce_grads(loss, leaves, group)
        opt_state = optim.update(leaves, grads, opt_state, learning_rate)
        return params, opt_state, img.detach(), total
    return cfg, step
