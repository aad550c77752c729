"""Adaptive sampling: variance-driven per-pixel sample reallocation.

Counterpart of project3_cuda_path_tracer_tpu/render/adaptive.py, its host
planner kept as its own copy (the JAX module's numpy code, returning torch
tensors where it returns jnp arrays):

  * every iteration still traces exactly W*H paths, but path i shoots at
    pixel `pix[i]` from a host-planned mapping;
  * the planner runs on the host once per epoch: a relative-error image
    (`error_image`, on the device) from (accum, accum2, count), the
    largest-remainder apportionment of the W*H path budget, then
    pix = repeat(arange, n_i), so each pixel's paths are contiguous;
  * per-path stratified streams are keyed on the surrogate
    pix + occurrence * W*H, so co-located paths draw distinct samples
    (ops/wavefront.generate_rays_planar `strat_index`).

Estimator: accum[p] = sum of samples, count[p] = how many; the display
image is accum / count. Each sample is an unbiased radiance estimate and
the allocation depends only on past samples, so each pixel's mean stays
unbiased (the sequential-sampling argument).

The device side (`render_radiance_adaptive`, and Renderer's adaptive step)
scatters each iteration's radiance into pixel space at once, where the JAX
package sums a chunk of iterations in path space and scatters at its end
(a TPU scatter cost; on the card the scatter is cheap). The scatter is
`index_put_(accumulate=True)`, which sums the paths of one pixel in a fixed
order on the card as on the CPU (a sort, then a sum a run), so a render
does not depend on the order of atomics. The two packages group the sums
differently, so they agree to float re-association, not bit for bit.

`plan_epoch_sharded` and `identity_plan_sharded` are the planners of the
sharded renderer (parallel/sharding.py): each rank's row block gets its
own W*H/world paths, apportioned within the block, so every path's pixel
stays in its rank's accumulator rows.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import bvh8 as B8
from ..scene import types as T
from . import integrator as I

# Rec.709 luma weights for the error metric (integrator._lum's)
_LW = (0.2126, 0.7152, 0.0722)


def render_radiance_adaptive(materials, cam, geoms, textures, cfg,
                             generator=None, iteration=None,
                             packed_meshes: tuple = (),
                             meshes: Optional[T.MeshBundle] = None,
                             pix_override=None, samp_index=None,
                             light_gen=None):
    """One adaptive iteration -> (radiance image [H,W,3], lum^2 image
    [H,W]): `trace_wavefront` under cfg.adaptive with the path->pixel
    mapping `pix_override` and the surrogates `samp_index`, its per-path
    radiance and luminance^2 summed into pixel space by
    `index_put_(accumulate=True)` (deterministic: module docstring)."""
    rad, pix = I.trace_wavefront(
        materials, cam, geoms, textures, cfg, generator=generator,
        iteration=iteration, packed_meshes=packed_meshes, meshes=meshes,
        light_gen=light_gen, pix_override=pix_override,
        samp_index=samp_index)
    dev = rad.x.device
    img = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=dev)
    lum2 = torch.zeros((cfg.height, cfg.width), dtype=torch.float32,
                       device=dev)
    img.view(-1, 3).index_put_((pix,), torch.stack(tuple(rad), dim=-1),
                               accumulate=True)
    lum = I._lum(rad)
    lum2.view(-1).index_put_((pix,), lum * lum, accumulate=True)
    return img, lum2


def error_image(accum: torch.Tensor, accum2: torch.Tensor,
                count: torch.Tensor) -> torch.Tensor:
    """Device-side relative-standard-error image [H,W] float32 (the replan
    pulls this one plane, not the accumulators). Computed in float64:
    var = sum(l^2)/n - mean^2 cancels where a pixel's variance is small,
    and float32 there is off by ~1e-6 (the JAX package's float32 program
    too, whose XLA fusion rounds differently)."""
    f64 = torch.float64
    accum, accum2, count = accum.to(f64), accum2.to(f64), count.to(f64)
    cnt = torch.clamp(count, min=1.0)
    lum = (accum[..., 0] * _LW[0] + accum[..., 1] * _LW[1]
           + accum[..., 2] * _LW[2])
    mean = lum / cnt
    var = torch.clamp(accum2 / cnt - mean ** 2, min=0.0)
    g = torch.clamp(torch.sum(lum) / torch.sum(cnt), min=1e-12)
    err = (torch.sqrt(var / cnt) + 0.5 * g / cnt) / (mean + 0.1 * g + 1e-6)
    return err.to(torch.float32)


def apportion(weights: np.ndarray, total: int) -> np.ndarray:
    """Largest-remainder apportionment: integer n_i >= 0 summing exactly
    to `total`, proportional to non-negative `weights`."""
    w = np.maximum(np.asarray(weights, np.float64).ravel(), 0.0)
    s = w.sum()
    if s <= 0:
        w = np.ones_like(w)
        s = w.sum()
    quota = w * (total / s)
    n = np.floor(quota).astype(np.int64)
    short = total - int(n.sum())
    if short > 0:
        rem = quota - n
        top = np.argpartition(rem, -short)[-short:]
        n[top] += 1
    return n


def plan_epoch(accum: np.ndarray, accum2: np.ndarray, count: np.ndarray,
               floor_frac: float = 0.15):
    """Host epoch planner: (pix, surrogate, count_image) for the next
    epoch from the running sums (numpy).

    Error metric: the relative standard error of the per-pixel mean,
    sqrt(var/n) / (mean + eps), plus an exploration term at the scale of
    the global mean luminance that decays as 1/n (a pixel whose few samples
    all missed the light reads var = 0 and would never be sampled again).
    `floor_frac` mixes in a uniform floor, so every pixel keeps being
    sampled."""
    cnt = np.maximum(np.asarray(count, np.float64), 1.0)
    lum = (np.asarray(accum[..., 0], np.float64) * _LW[0]
           + np.asarray(accum[..., 1], np.float64) * _LW[1]
           + np.asarray(accum[..., 2], np.float64) * _LW[2])
    mean = lum / cnt
    var = np.maximum(np.asarray(accum2, np.float64) / cnt - mean ** 2, 0.0)
    g = max(float(lum.sum() / cnt.sum()), 1e-12)
    err = (np.sqrt(var / cnt) + 0.5 * g / cnt) / (mean + 0.1 * g + 1e-6)
    return plan_from_err(err, floor_frac)


def _mesh_box(packed) -> tuple:
    """(lo, hi) [3] of a packed mesh's object-space box: the union of the
    root's child boxes in the 8-wide layout (ops/bvh8.py: cols 0-47 of row
    0, an empty slot NaN), the root's own box in the binary one."""
    if isinstance(packed, B8.PackedMesh8):
        boxes = packed.nodes[0, 0:48].detach().cpu().numpy().reshape(8, 6)
        ok = np.isfinite(boxes[:, 0])
        return boxes[ok, 0:3].min(0), boxes[ok, 3:6].max(0)
    root = packed.nodes_f[0].detach().cpu().numpy()
    return root[0:3], root[3:6]


def cost_proxy_image(scene: T.Scene, width: int, height: int,
                     mesh_ratio: float = 128.0) -> np.ndarray:
    """Host-side per-pixel cost proxy [h,w]: 1.0 for pixels whose primary
    ray misses every mesh geom's world AABB, `mesh_ratio` for the rest;
    all ones on a scene without meshes.

    Neyman allocation under heterogeneous cost is n ~ err/sqrt(cost); this
    proxy captures the dominant cost cliff (a BVH traversal against a
    primitive ray), so the planner does not move the budget from near-free
    sky rays onto traversal rays."""
    gtypes = scene.geoms.type.tolist()
    mesh_geoms = [g for g, t in enumerate(gtypes) if t == T.MESH]
    if not mesh_geoms or not scene.packed_meshes:
        return np.ones((height, width), np.float32)
    cam = {k: v.numpy() for k, v in scene.camera.flat().items()}
    idx = np.arange(width * height)
    x = (idx % width).astype(np.float64) + 0.5
    y = (idx // width).astype(np.float64) + 0.5
    sx = cam["pixel_length"][0] * (x - width * 0.5)
    sy = cam["pixel_length"][1] * (y - height * 0.5)
    d = (cam["view"][None, :] - cam["right"][None, :] * sx[:, None]
         - cam["up"][None, :] * sy[:, None])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = cam["position"][None, :]
    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
    hit_any = np.zeros(width * height, bool)
    xf = scene.geoms.transform.detach().cpu().numpy()
    mids = scene.geoms.mesh_id.tolist()
    for g in mesh_geoms:
        lo_o, hi_o = _mesh_box(scene.packed_meshes[int(mids[g])])
        # world AABB of the transformed object box (8 corners)
        cs = np.stack(np.meshgrid(*[[lo_o[k], hi_o[k]] for k in range(3)],
                                  indexing="ij"), -1).reshape(-1, 3)
        cw = cs @ xf[g][:3, :3].T + xf[g][:3, 3]
        lo, hi = cw.min(0), cw.max(0)
        t1 = (lo[None, :] - o) * inv
        t2 = (hi[None, :] - o) * inv
        tmin = np.minimum(t1, t2).max(1)
        tmax = np.maximum(t1, t2).min(1)
        hit_any |= (tmax >= tmin) & (tmax > 0)
    cost = np.where(hit_any, mesh_ratio, 1.0).astype(np.float32)
    return cost.reshape(height, width)


def plan_from_err(err: np.ndarray, floor_frac: float = 0.15,
                  tile: int = 0, cost: Optional[np.ndarray] = None):
    """(pix, surrogate, count_image) from a host error image: pix and the
    surrogates as int64 tensors (on the CPU), count_image a float32 [h,w]
    numpy array.

    `tile` > 0 emits the paths in TxT pixel-tile-major order (the JAX
    package's mesh-scene order; the port's renderer passes 0, row-major
    pixel order). `cost` applies the Neyman damping n ~ err/sqrt(cost)."""
    h, w = err.shape
    npix = h * w
    err = np.asarray(err, np.float64)
    u = err.sum() / npix
    err = (1.0 - floor_frac) * err + floor_frac * max(u, 1e-12)
    if cost is not None:
        err = err / np.sqrt(np.asarray(cost, np.float64))
    n = apportion(err, npix)
    if tile and h % tile == 0 and w % tile == 0:
        order = identity_plan(w, h, tile)[0].numpy()
        pix = np.repeat(order, n[order])
    else:
        pix = np.repeat(np.arange(npix, dtype=np.int64), n)
    # occurrence index within each pixel's run (runs are contiguous in
    # either emission order)
    change = np.empty(npix, bool)
    change[0] = True
    np.not_equal(pix[1:], pix[:-1], out=change[1:])
    run_start = np.maximum.accumulate(
        np.where(change, np.arange(npix, dtype=np.int64), 0))
    occ = np.arange(npix, dtype=np.int64) - run_start
    # int32-safe surrogate: occurrences past the cap reuse a stream
    cap = (2 ** 31 - 1) // npix - 1
    surr = pix + np.minimum(occ, cap) * npix
    count_img = n.reshape(h, w).astype(np.float32)
    return torch.from_numpy(pix), torch.from_numpy(surr), count_img


def plan_epoch_sharded(accum: np.ndarray, accum2: np.ndarray,
                       count: np.ndarray, ndev: int,
                       floor_frac: float = 0.15):
    """Per-rank adaptive plan (the JAX `plan_epoch_sharded`): the pixel rows
    split into `ndev` equal row blocks, each block's W*H/ndev path budget
    apportioned within the block, so every path's pixel stays on its own
    rank. Returns (pix, surrogate) as int64 tensors (global pixel ids,
    block after block) and the count image, float32 numpy [h, w]."""
    h, w = count.shape
    if h % ndev:
        raise ValueError(f"height {h} not divisible by {ndev} ranks")
    rows = h // ndev
    cnt = np.maximum(np.asarray(count, np.float64), 1.0)
    lum = (np.asarray(accum[..., 0], np.float64) * _LW[0]
           + np.asarray(accum[..., 1], np.float64) * _LW[1]
           + np.asarray(accum[..., 2], np.float64) * _LW[2])
    mean = lum / cnt
    var = np.maximum(np.asarray(accum2, np.float64) / cnt - mean ** 2, 0.0)
    g = max(float(lum.sum() / cnt.sum()), 1e-12)
    err = (np.sqrt(var / cnt) + 0.5 * g / cnt) / (mean + 0.1 * g + 1e-6)
    npix_loc = rows * w
    pix_all, surr_all, cimg_all = [], [], []
    for d in range(ndev):
        e = np.asarray(err[d * rows:(d + 1) * rows], np.float64)
        u = e.sum() / npix_loc
        e = (1.0 - floor_frac) * e + floor_frac * max(u, 1e-12)
        n = apportion(e, npix_loc)
        pix = d * npix_loc + np.repeat(np.arange(npix_loc, dtype=np.int64),
                                       n)
        starts = np.concatenate([[0], np.cumsum(n)[:-1]])
        occ = np.arange(npix_loc, dtype=np.int64) - np.repeat(starts, n)
        cap = (2 ** 31 - 1) // (h * w) - 1
        surr_all.append(pix + np.minimum(occ, cap) * (h * w))
        pix_all.append(pix)
        cimg_all.append(n.reshape(rows, w))
    return (torch.from_numpy(np.concatenate(pix_all)),
            torch.from_numpy(np.concatenate(surr_all)),
            np.concatenate(cimg_all).astype(np.float32))


def identity_plan_sharded(width: int, height: int, ndev: int,
                          tile: int = 0):
    """Warm-up mapping of the sharded renderer (the JAX
    `identity_plan_sharded`): the identity, or a per-block tile swizzle
    when the tile divides the block's rows (a tile across two blocks would
    move paths between ranks)."""
    rows = height // ndev
    if tile and (rows % tile or width % tile):
        tile = 0
    idx = torch.cat([identity_plan(width, rows, tile)[0] + d * rows * width
                     for d in range(ndev)])
    return idx, idx.clone(), np.ones((height, width), np.float32)


def identity_plan(width: int, height: int, tile: int = 0):
    """Warm-up mapping: path i -> pixel i (or the TxT tile swizzle),
    bit for bit the uniform render."""
    npix = width * height
    idx = np.arange(npix, dtype=np.int64)
    if tile and width % tile == 0 and height % tile == 0:
        per = tile * tile
        tpr = width // tile
        xi = (idx // per % tpr) * tile + idx % per % tile
        yi = (idx // per // tpr) * tile + idx % per // tile
        idx = xi + yi * width
    t = torch.from_numpy(idx)
    return t, t.clone(), np.ones((height, width), np.float32)
