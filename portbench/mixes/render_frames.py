"""Progressive frames, as the program's live preview shows them: a frame is
`iterations_per_frame` iterations through `Renderer.step_many` (graph
replays on the wavefront route, one K1 launch an iteration on the
megakernel route), then `Renderer.image()`, the mean image on the host,
which the preview's page fetches once a second (app/preview.py). The
draws are the stratified lattice, so the reference can retrace any pixel
at any iteration; `nee` turns on area-light next-event estimation.

The check: the image after the window against the reference's retrace of
a sample of pixels (drawn from the seed) over every iteration the program
ran."""
from __future__ import annotations

import os

import torch

from harness import inputs, roofline
from harness.checks import image_gap
from reference import scene as RS
from reference import tracer as R

REF_BLOCK = 1 << 20          # lanes a reference call traces
LIVE_STRIDE_MESH = 16        # a mesh frame's live counts: 1 pixel in 16


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Mix:
    rate_metric = "render_segments_per_s"

    def __init__(self, ctx):
        self.ctx = ctx
        p = ctx.cell.traffic["params"]
        self.iters = int(p["iterations_per_frame"])
        # each iteration runs the same kernels (image() only copies)
        self.repeats_per_unit = self.iters
        self.nee = bool(p.get("nee", False))
        self.r = None

    def setup(self) -> None:
        from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
        ctx = self.ctx
        self.path = inputs.write_scene(ctx.cell.config, ctx.seed)
        with ctx.span("scene_load"):
            scene = load_scene(self.path)
        scene.settings.stratified = True
        scene.settings.nee = self.nee
        w, h = scene.camera.resolution
        self.w, self.h, self.depth = w, h, scene.settings.trace_depth
        self.work_per_unit = self.iters * w * h * self.depth
        with ctx.span("renderer"):
            self.r = Renderer(scene, device=ctx.device.type)
        # the first iteration runs eagerly and builds the kernel libraries
        # it uses (a checkout's first run compiles them), the rest capture
        # the iteration's graph and replay it
        with ctx.span("warm"):
            self.r.step_many(self.iters)
            self.image = self.r.image()

    def unit(self) -> None:
        # the frame's iterations to completion (as the CLI's loop waits for
        # them), then the readback alone
        with self.ctx.span("step_many"):
            self.r.step_many(self.iters)
            _sync(self.ctx.device)
        with self.ctx.span("image"):
            self.image = self.r.image()

    def finish(self) -> None:
        r = self.r
        self.n = r.iteration
        self.route = r.route
        g = r.graph
        self.capture = None if g is None else (g.capture_s, g.instantiate_s)
        self.r = None

    def _reference(self, device):
        with open(self.path) as f:
            sc = RS.parse(f.read(), os.path.dirname(self.path))
        return sc, R.Tables(sc, device)

    def check(self) -> dict:
        dev = self.ctx.device
        sc, tab = self._reference(dev)
        k = int(self.ctx.cell.settings["check_pixels"])
        pix = torch.as_tensor(inputs.pixel_sample(self.ctx.seed,
                                                  self.w * self.h, k),
                              device=dev)
        acc = torch.zeros((pix.numel(), 3), dtype=torch.float64, device=dev)
        lanes = pix.numel() * self.n
        for s in range(0, lanes, REF_BLOCK):
            idx = torch.arange(s, min(s + REF_BLOCK, lanes), device=dev)
            slot, it = idx // self.n, idx % self.n
            rad = R.trace(tab, pix[slot], R.LatticeDraws(it, pix[slot]),
                          sc.depth, nee=self.nee)
            acc.index_add_(0, slot, rad.double())
        ref = (acc / self.n).cpu().numpy()
        p = pix.cpu().numpy()
        # image() is mirrored in x (saveImage's convention)
        prog = self.image[p // self.w, self.w - 1 - p % self.w]
        return dict(image_gap=image_gap(prog, ref))

    def layer_records(self, records: dict) -> dict:
        """What the per-layer readers need beyond the profiler's records:
        the sub-window's iterations, the graph's capture, and on a mesh
        scene K2's bytes an iteration, from the live rays of the reference's
        own retrace of the sub-window's first iteration."""
        its = records["units"] * self.iters
        out = dict(iterations=its, steps=None, capture=self.capture)
        dev = self.ctx.device
        sc, tab = self._reference(dev)
        if not any(g.kind == RS.MESH for g in sc.geoms):
            return out
        first = self.n - its
        pix = torch.arange(0, self.w * self.h, LIVE_STRIDE_MESH, device=dev)
        live = None
        for s in range(0, pix.numel(), REF_BLOCK):
            p = pix[s:s + REF_BLOCK]
            st = {}
            with torch.no_grad():
                R.trace(tab, p, R.LatticeDraws(torch.full_like(p, first), p),
                        sc.depth, nee=self.nee, stats=st)
            live = st["live"] if live is None else [
                a + b for a, b in zip(live, st["live"])]
        tris = sum(g.mesh.corners.shape[0] for g in sc.geoms
                   if g.kind == RS.MESH)
        out["k2_works"] = [roofline.k2_work(self.w * self.h,
                                            n * LIVE_STRIDE_MESH, tris)
                           for n in live]
        return out
