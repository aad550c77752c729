"""The fwd+bwd train step of fitting scene parameters through the render,
in bench.py's history-residual form: a unit is one call of the program's
`make_train_scan` of `steps_per_call` steps (the graph replays a whole step:
render, loss, autograd, Adam, the history), with the loss read back after
the call, toward a black target. Each call draws from its own seed, so no
two steps render the same samples. Set-up makes the parameters, Adam's
state and the history (one render), then runs the first three calls (the
eager step, the capture, the first replay) through the window's own call;
the reference follows those three.

The check: each of the three steps' loss, the first step's gradient (from
Adam's first moment) and the parameters' change over the three, against the
reference's train step on the same inputs."""
from __future__ import annotations

import dataclasses
import os

import torch

from harness import inputs
from harness.checks import ADAM_B1, train_numbers
from reference import scene as RS
from reference import train as RT

CHECKED_CALLS = 3
MAX_CALLS = 100000


class Mix:
    rate_metric = "train_segments_per_s"

    def __init__(self, ctx):
        self.ctx = ctx
        p = ctx.cell.traffic["params"]
        self.steps = int(p["steps_per_call"])
        self.repeats_per_unit = self.steps
        if self.steps != 1:
            raise ValueError("the check follows calls of one step each")
        self.lr = float(p["learning_rate"])
        self.calls = 0
        self.seeds = inputs.call_seeds(ctx.seed, MAX_CALLS)

    def _names(self, params):
        from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
        mats = [f.name for f in dataclasses.fields(params.materials)
                if getattr(params.materials, f.name) is not None]
        names = (["materials." + k for k in mats]
                 + ["cam." + k for k in sorted(params.cam)])
        if len(names) != len(PInv.param_leaves(params)):
            raise ValueError("the leaves' names do not match param_leaves")
        return names

    def _host(self, tensors):
        return {k: t.detach().double().cpu() for k, t in
                zip(self.names, tensors)}

    def setup(self) -> None:
        from project3_cuda_path_tracer_tpu_torch import load_scene
        from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
        from project3_cuda_path_tracer_tpu_torch.models import optim
        from project3_cuda_path_tracer_tpu_torch.ops import texfetch
        from project3_cuda_path_tracer_tpu_torch.render import \
            integrator as PI
        ctx, dev = self.ctx, self.ctx.device
        self.path = inputs.write_scene(ctx.cell.config, ctx.seed)
        with ctx.span("scene_load"):
            scene = load_scene(self.path)
        w, h = scene.camera.resolution
        cfg = PInv.train_config(scene)
        self.work_per_unit = self.steps * w * h * cfg.trace_depth
        with ctx.span("state"):
            tables = (PI.to_device(scene.geoms, dev),
                      PI.to_device(scene.meshes, dev),
                      texfetch.fuse(PI.to_device(scene.textures, dev)))
            packed = tuple(PI.to_device(p, dev)
                           for p in scene.packed_meshes)
            self.params = PInv.params_from_scene(scene, dev)
            self.names = self._names(self.params)
            self.opt = optim.init(PInv.param_leaves(self.params))
            self.hist_seed = inputs.history_seed(ctx.seed)
            self.hist = PInv.make_seed_history(*tables, cfg, packed)(
                self.params, PInv.step_generator(self.hist_seed, 0, dev))
            self.target = torch.zeros_like(self.hist)
            self.run = PInv.make_train_scan(
                *tables, cfg, num_steps=self.steps,
                learning_rate=self.lr, packed_meshes=packed, history=True)
        self.start = self._host(PInv.param_leaves(self.params))
        self.losses = []
        with ctx.span("warm"):
            for c in range(CHECKED_CALLS):
                self._call()
                if c == 0:
                    self.grad = {k: v / (1.0 - ADAM_B1) for k, v in
                                 self._host(self.opt.mu).items()}
            self.after = self._host(PInv.param_leaves(self.params))

    def _call(self) -> None:
        self.params, self.opt, self.hist, losses = self.run(
            self.params, self.opt, self.hist, self.seeds[self.calls],
            self.target)
        self.calls += 1
        self.losses.append(losses.cpu().tolist())

    def unit(self) -> None:
        with self.ctx.span("train_call"):
            self._call()

    def finish(self) -> None:
        g = self.run.train_graph.graph
        self.capture = None if g is None else (g.capture_s, g.instantiate_s)
        self.run = self.params = self.opt = self.hist = None

    def check(self) -> dict:
        with open(self.path) as f:
            sc = RS.parse(f.read(), os.path.dirname(self.path))
        ref = RT.train(sc, self.ctx.device,
                       inputs.seed32(self.hist_seed, 0),
                       [inputs.seed32(s, 0) for s in
                        self.seeds[:CHECKED_CALLS]], lr=self.lr)
        program = dict(losses=[c[0] for c in self.losses[:CHECKED_CALLS]],
                       grad=self.grad, start=self.start, after=self.after)
        return train_numbers(program, dict(
            losses=ref["losses"], grad=ref["grads"][0], start=ref["start"],
            after=ref["params"][CHECKED_CALLS - 1]))

    def layer_records(self, records: dict) -> dict:
        return dict(iterations=None, steps=records["units"] * self.steps,
                    capture=self.capture)
