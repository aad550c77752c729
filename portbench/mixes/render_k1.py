"""Frames on the megakernel route (K1, one launch an iteration), driven as
mixes/render_frames.py drives its scenes: the same set-up, spans and
records, with the check and the work counts of reference/texenv.py, which
knows the refractive lobe.

Two kinds of unit, by the traffic's `reset_per_unit`:
- false, the live preview: `iterations_per_frame` more iterations through
  `Renderer.step_many`, then `image()`, the mean so far;
- true, a still as the reference program renders one: `Renderer.reset()`
  (the accumulator zeroed, K1's scene table packed anew), the scene's
  iterations, then one `image()`.

The check: `image_gap` as render_frames.py takes it, and `mean_gap`, the
gap of the sampled pixels' summed radiance, |sum program - sum reference|
/ sum reference, which sees a bias spread thinly over the frame that a few
hundred pixels' absolute gap may miss. The traced unit's kernels: a frame
runs one K1 launch an iteration; a still adds the reset's one fill, so its
repeats are whole units and the cell traces two of them, and a dropped K1
record leaves an odd count."""
from __future__ import annotations

import numpy as np
import torch

from harness import inputs, roofline_k1
from harness.checks import image_gap
from mixes import render_frames
from reference import scene as RS
from reference import texenv as TX


def mean_gap(program: np.ndarray, reference: np.ndarray) -> float:
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    if not np.isfinite(program).all():
        return float("inf")
    den = abs(reference.sum())
    return float(abs(program.sum() - reference.sum()) / max(den, 1e-30))


class Mix(render_frames.Mix):

    def __init__(self, ctx):
        super().__init__(ctx)
        p = ctx.cell.traffic["params"]
        self.reset_per_unit = bool(p.get("reset_per_unit", False))
        if self.reset_per_unit:
            self.repeats_per_unit = 1

    def setup(self) -> None:
        super().setup()
        if self.r.route != "megakernel":
            raise RuntimeError(f"the scene takes the {self.r.route} route, "
                               "not the megakernel's")

    def unit(self) -> None:
        if self.reset_per_unit:
            with self.ctx.span("reset"):
                self.r.reset()
        super().unit()

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
        return dict(image_gap=image_gap(prog, ref),
                    mean_gap=mean_gap(prog, ref))

    def layer_records(self, records: dict) -> dict:
        """The sub-window's iterations, and K1's operations an iteration
        from the segments of the reference's retrace of the sub-window's
        first iteration on a 1-in-16 pixel lattice."""
        its = records["units"] * self.iters
        out = dict(iterations=its, steps=None, capture=self.capture)
        dev = self.ctx.device
        ts, tab = self._reference(dev)
        sc = ts.scene
        # a still's units each start at iteration 0
        first = 0 if self.reset_per_unit else self.n - its
        stride = render_frames.LIVE_STRIDE_MESH
        pix = torch.arange(0, self.w * self.h, stride, device=dev)
        counts = None
        for s in range(0, pix.numel(), TX.REF_BLOCK):
            c = roofline_k1.segment_counts(tab, pix[s:s + TX.REF_BLOCK],
                                           first, sc.depth)
            counts = c if counts is None else {
                k: [a + b for a, b in zip(counts[k], c[k])] for k in c}
        counts = {k: [n * stride for n in v] for k, v in counts.items()}
        kinds = ["cube" if g.kind == RS.CUBE else "sphere" for g in sc.geoms]
        out["k1_works"] = [roofline_k1.k1_work(
            self.w * self.h, counts, kinds,
            motion=float(np.asarray(sc.camera["shutter"])) > 0,
            lens=float(np.asarray(sc.camera["aperture"])) > 0,
            sampler="stratified",   # render_frames renders the lattice
            table_floats=roofline_k1.table_floats(
                len(sc.geoms), len(sc.materials["emittance"])))]
        return out
