"""The plain reference against the program on the CPU at small sizes: the
same scene text and draws give the same images and the same train steps."""
import numpy as np
import pytest
import torch

import pb_small
from harness import inputs
from reference import scene as RS
from reference import tracer as R
from reference import train as RT

SEED = 2 ** 31 + 3


def _scene(c, tmp_path):
    text = inputs.scene_text(c.config, SEED)
    path = tmp_path / "scene.txt"
    path.write_text(text)
    return str(path), RS.parse(text, str(tmp_path))


@pytest.mark.parametrize("name,nee,mesh", [
    ("cornell-train", False, False),       # cornell, K1's plain route
    ("cornell-nee-render", True, False),   # area-light NEE
    ("mesh-render", False, True),          # a mesh through the BVH
])
def test_images_match_the_program(tmp_path, name, nee, mesh):
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    c = (pb_small.tiny_mesh_cell(tmp_path) if mesh
         else pb_small.cell(name, (20, 14), 5))
    path, sc = _scene(c, tmp_path)
    scene = load_scene(path)
    scene.settings.stratified = True
    scene.settings.nee = nee
    r = Renderer(scene, device="cpu")
    n = 5
    r.step_many(n)
    w, h = sc.width, sc.height
    pix = torch.arange(w * h).repeat(n)
    it = torch.arange(n).repeat_interleave(w * h)
    rad = R.trace(R.Tables(sc, "cpu"), pix, R.LatticeDraws(it, pix),
                  sc.depth, nee=nee)
    ref = torch.zeros(w * h, 3, dtype=torch.float64).index_add_(
        0, pix, rad.double()).numpy().reshape(h, w, 3) / n
    img = r.image()[:, ::-1, :]        # image() is mirrored in x
    assert np.abs(ref).sum() > 0
    np.testing.assert_allclose(img, ref, rtol=0, atol=2e-6)


def test_train_steps_match_the_program(tmp_path):
    from project3_cuda_path_tracer_tpu_torch import load_scene
    from project3_cuda_path_tracer_tpu_torch.models import inverse as PInv
    from project3_cuda_path_tracer_tpu_torch.models import optim
    c = pb_small.cell("cornell-train", (20, 14), 4)
    path, sc = _scene(c, tmp_path)
    scene = load_scene(path)
    cfg = PInv.train_config(scene)
    dev = torch.device("cpu")
    params = PInv.params_from_scene(scene, dev)
    opt = optim.init(PInv.param_leaves(params))
    hist = PInv.make_seed_history(scene.geoms, scene.meshes, scene.textures,
                                  cfg)(params,
                                       PInv.step_generator(11, 0, dev))
    run = PInv.make_train_scan(scene.geoms, scene.meshes, scene.textures,
                               cfg, num_steps=1, history=True)
    target = torch.zeros_like(hist)
    seeds = [101, 202, 303]
    losses, mu1 = [], None
    for s in seeds:
        params, opt, hist, loss = run(params, opt, hist, s, target)
        losses.append(float(loss[0]))
        mu1 = mu1 or [m.clone() for m in opt.mu]
    ref = RT.train(sc, "cpu", inputs.seed32(11, 0),
                   [inputs.seed32(s, 0) for s in seeds])
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    got = dict(zip(["color", "specular_exponent", "specular_color",
                    "has_reflective", "has_refractive", "ior", "emittance"],
                   mu1))
    for k, m in got.items():
        np.testing.assert_allclose(m.double().numpy() / 0.1,
                                   ref["grads"][0]["materials." + k].numpy(),
                                   rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(
        params.materials.color.detach().double().numpy(),
        ref["params"][2]["materials.color"].numpy(), rtol=0, atol=1e-5)
