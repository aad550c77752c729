"""`correct` comes out false when the timed path is broken underneath (the
program patched, the rest of a run driven as on the card), and the control
(the reference in bfloat16 in the program's place) fails its cell's limits,
both at a size a CPU test holds."""
import pytest
import torch

import pb_small
import control  # noqa: E402  (pb_small puts it on the path)
from harness import runner

CPU = torch.device("cpu")


def _run(c):
    return runner.run(c, 2 ** 31 + 21, 0.2, False, CPU, 0.0)


def _render_faults(monkeypatch, fault):
    from project3_cuda_path_tracer_tpu_torch.render import integrator as I
    if fault == "unchanged":
        monkeypatch.setattr(I.Renderer, "_iterate",
                            lambda self, g, lg: None)
        return
    clean = I.to_image

    def broken(rad, cfg):
        img = clean(rad, cfg)
        if fault == "half":
            keep = (torch.arange(img.shape[0]) < img.shape[0] // 2)
            return img * (2.0 * keep.to(img.dtype))[:, None, None]
        return img * 1.1
    monkeypatch.setattr(I, "to_image", broken)


def _train_faults(monkeypatch, fault):
    from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
    from project3_cuda_path_tracer_tpu_torch.models import optim
    from project3_cuda_path_tracer_tpu_torch.render import integrator as I
    if fault == "unchanged":
        monkeypatch.setattr(optim, "update_", lambda *a, **k: None)
    elif fault == "half":
        def half_loss(params, geoms, meshes, textures, generator, cfg,
                      target, residual, packed_meshes=(), iteration=None):
            img = PInv.render_image(params, geoms, meshes, textures,
                                    generator, cfg, packed_meshes, iteration)
            h = img.shape[0] // 2
            return 2.0 * torch.mean((residual.detach() - target)[:h]
                                    * img[:h]), img
        monkeypatch.setattr(PInv, "history_residual_grad_loss", half_loss)
    else:
        clean = I.render_radiance
        monkeypatch.setattr(I, "render_radiance",
                            lambda *a, **k: clean(*a, **k) * 1.05)


def test_sound_runs_are_correct():
    assert _run(pb_small.cell("cornell-nee-render"))["correct"] is True
    assert _run(pb_small.cell("cornell-train", (20, 14), 4))["correct"] \
        is True


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_render_faults_fail(monkeypatch, fault):
    _render_faults(monkeypatch, fault)
    out = _run(pb_small.cell("cornell-nee-render"))
    assert out["correct"] is False and out["failed"] == out["attempted"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_train_faults_fail(monkeypatch, fault):
    _train_faults(monkeypatch, fault)
    out = _run(pb_small.cell("cornell-train", (20, 14), 4))
    assert out["correct"] is False


def test_render_control_fails():
    c = pb_small.cell("cornell-nee-render")
    nums = control.render_numbers(c, 2 ** 31 + 9, 40, CPU)
    assert nums["image_gap"] > c.settings["limits"]["image_gap"]


def test_train_control_fails():
    c = pb_small.cell("cornell-train", (20, 14), 4)
    nums = control.train_numbers(c, 2 ** 31 + 9, CPU)
    assert any(v > c.settings["limits"][k] for k, v in nums.items())
