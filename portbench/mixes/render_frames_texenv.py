"""Progressive frames of a scene with textures, an HDR sky and glass
(textured_env), driven as mixes/render_frames.py drives its scenes: the
same set-up, frame, spans and records. The check and the per-layer work
counts come from reference/texenv.py, which knows the images, the sky, the
refractive lobe and the uvs.

Set-up runs inside the program's `recording()`, so that its spans of the
texture decode and upload exist for `texture_load_s`: the program records
a span only under a profiler or there. So this cell's `setup_s` is taken
with the recorder on (a few spans, microseconds each); the other cells'
set-up runs with it off."""
from __future__ import annotations

import contextlib

import torch

from harness import inputs, program_spans, roofline, roofline_tex
from harness.checks import image_gap
from mixes import render_frames
from reference import scene as RS
from reference import texenv as TX
from reference import tracer as R


def _recording():
    p = program_spans._recorder()
    return contextlib.nullcontext() if p is None else p.recording()


class Mix(render_frames.Mix):

    def setup(self) -> None:
        with _recording():
            super().setup()

    def _reference(self, device):
        ts = TX.load(self.path)
        return ts, TX.Tables(ts, device)

    def check(self) -> dict:
        dev = self.ctx.device
        ts, tab = self._reference(dev)
        k = int(self.ctx.cell.settings["check_pixels"])
        pix = torch.as_tensor(inputs.pixel_sample(self.ctx.seed,
                                                  self.w * self.h, k),
                              device=dev)
        ref = TX.retrace(tab, pix, self.n, ts.scene.depth)
        p = pix.cpu().numpy()
        # image() is mirrored in x (saveImage's convention)
        prog = self.image[p // self.w, self.w - 1 - p % self.w]
        return dict(image_gap=image_gap(prog, ref))

    def layer_records(self, records: dict) -> dict:
        """The sub-window's iterations and the graph's capture, and an
        iteration's K2 and P1 bytes, from the lanes of the reference's own
        retrace of the sub-window's first iteration on a 1-in-16 pixel
        lattice: K2's from the live rays (the mesh's triangles once), P1's
        from the lanes that read a texel (the fused table once)."""
        its = records["units"] * self.iters
        out = dict(iterations=its, steps=None, capture=self.capture)
        dev = self.ctx.device
        ts, tab = self._reference(dev)
        first = self.n - its
        stride = render_frames.LIVE_STRIDE_MESH
        pix = torch.arange(0, self.w * self.h, stride, device=dev)
        sums = {}
        for s in range(0, pix.numel(), TX.REF_BLOCK):
            p = pix[s:s + TX.REF_BLOCK]
            st = {}
            with torch.no_grad():
                TX.trace(tab, p, R.LatticeDraws(torch.full_like(p, first), p),
                         ts.scene.depth, stats=st)
            for key, xs in st.items():
                sums[key] = [a + b for a, b in
                             zip(sums.get(key, [0] * len(xs)), xs)]
        lanes = self.w * self.h
        tris = sum(g.mesh.corners.shape[0] for g in ts.scene.geoms
                   if g.kind == RS.MESH)
        if tris:
            out["k2_works"] = [roofline.k2_work(lanes, n * stride, tris)
                               for n in sums["live"]]
        # the fused table: the distinct images stacked into an atlas as
        # wide as the widest, then the sky
        images = {id(im): im for im in ts.textures if im is not None}
        texels = (sum(im.shape[0] for im in images.values())
                  * max((im.shape[1] for im in images.values()), default=0))
        if ts.env is not None:
            texels += ts.env.shape[0] * ts.env.shape[1]
        if texels:
            out["p1_works"] = [roofline_tex.p1_work(n * stride, texels)
                               for n in sums["fetches"]]
        return out
