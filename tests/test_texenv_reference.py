"""The textured_env deployment's plain reference (portbench/reference/
texenv.py) against the port on the CPU, and its cell `texenv-render`.

The port's wavefront render of a cut of the configuration (16x12, depth
3, a small uv'd octahedron in place of the torus) equals the reference to
<= 2e-6 over a few stratified iterations, seen three ways: the published
camera, the camera aimed at the glass sphere and at the mesh. The cell
resolves by name. Planted faults in the port each make the cell's
`correct` false on a whole run of the cut, and so does the control (the
reference in bfloat16 in the port's place). The reference imports nothing
of the port or of JAX.

    JAX_PLATFORMS=cpu python -m pytest tests/test_texenv_reference.py
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "portbench")
sys.path[:0] = [p for p in (os.path.join(BENCH, "tests"), BENCH)
                if p not in sys.path]

import control_texenv  # noqa: E402
import pb_small  # noqa: E402
from harness import inputs, runner, spec  # noqa: E402
from reference import texenv as TX  # noqa: E402
from reference import tracer as R  # noqa: E402

CELL = "texenv-render"
SEED = 2 ** 31 + 3
CPU = torch.device("cpu")

# an octahedron with a uv at each corner: the torus's stand-in
OCTAHEDRON_UV = """v 1 0 0
v -1 0 0
v 0 1 0
v 0 -1 0
v 0 0 1
v 0 0 -1
vt 0.1 0.2
vt 0.9 0.3
vt 0.5 0.95
vt 0.4 0.05
vt 0.7 0.6
vt 0.2 0.8
f 1/1 3/3 5/5
f 3/3 2/2 5/5
f 2/2 4/4 5/5
f 4/4 1/1 5/5
f 3/3 1/1 6/6
f 2/2 3/3 6/6
f 4/4 2/2 6/6
f 1/1 4/4 6/6
"""

# where the cut's camera looks: (LOOKAT, FOVY), None for the published one
VIEWS = {"published": None, "glass": ("2.6 1.1 1.2", 8),
         "mesh": ("-2.4 1.2 0", 8)}


def _cell(tmp_path, view="published"):
    """The cell with its scene cut to 16x12 and depth 3, the torus swapped
    for the uv'd octahedron and the camera aimed by `view`."""
    obj = tmp_path / "octa_uv.obj"
    obj.write_text(OCTAHEDRON_UV)
    c = pb_small.cell(CELL, (16, 12), 3)
    lines = c.config["scene"]
    if VIEWS[view] is not None:
        look, fovy = VIEWS[view]
        lines = ["LOOKAT " + look if ln.split()[:1] == ["LOOKAT"] else
                 "FOVY %d" % fovy if ln.split()[:1] == ["FOVY"] else ln
                 for ln in lines]
    c.config = dict(c.config, scene=lines,
                    meshes={k: str(obj) for k in c.config["meshes"]})
    return c


@pytest.mark.parametrize("view", list(VIEWS))
def test_images_match_the_program(tmp_path, view):
    """Every pixel over 4 iterations, and the lanes of the first: the view
    takes the glass lobe, misses into the sky and reads textured hits on
    the ground (published), the glass sphere (glass) or the mesh's uvs
    (mesh)."""
    from project3_cuda_path_tracer_tpu_torch import Renderer, load_scene
    path = inputs.write_scene(_cell(tmp_path, view).config, SEED)
    scene = load_scene(path)
    scene.settings.stratified = True
    r = Renderer(scene, device="cpu")
    assert r.route == "wavefront"
    n = 4
    r.step_many(n)
    ts = TX.load(path)
    w, h, depth = ts.scene.width, ts.scene.height, ts.scene.depth
    tab = TX.Tables(ts, "cpu")
    pix = torch.arange(w * h)
    ref = TX.retrace(tab, pix, n, depth).reshape(h, w, 3)
    st = {}
    TX.trace(tab, pix, R.LatticeDraws(torch.zeros_like(pix), pix), depth,
             stats=st)
    o, d, _ = R.camera_rays(tab, pix, R.LatticeDraws(torch.zeros_like(pix),
                                                     pix), dof=True)
    first = TX.intersect(tab, o, d, torch.ones_like(pix, dtype=torch.bool))
    mats = torch.bincount(first[-1][first[0] > 0], minlength=4).tolist()
    assert sum(st["glass"]) > 0 and sum(st["sky"]) > 0
    assert sum(st["fetches"]) > sum(st["sky"])
    if view == "glass":
        assert mats[3] > w * h // 3
    if view == "mesh":
        assert mats[1] > w * h // 4
    img = r.image()[:, ::-1, :]        # image() is mirrored in x
    assert np.abs(ref).sum() > 0
    np.testing.assert_allclose(img, ref, rtol=0, atol=2e-6)


def test_hdr_reader_decodes_flat_and_run_length_scanlines(tmp_path):
    """A flat scanline and a run-length one decode to (m + 0.5) *
    2^(e - 136), an exponent of 0 to black; the configuration's sky is the
    run-length kind."""
    texels = np.array([[[10, 20, 30, 130], [0, 0, 0, 0], [255, 1, 2, 140],
                        [7, 7, 7, 128]]] * 2, np.uint8)
    w = texels.shape[1]
    flat = texels[0].tobytes()
    rle = b"\x02\x02" + bytes([w >> 8, w & 255])
    for ch in range(4):
        rle += bytes([w]) + texels[1, :, ch].tobytes()   # literal bytes
    path = tmp_path / "two.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 4\n"
                     + flat + rle)
    got = TX.read_hdr(str(path))
    e = texels[..., 3].astype(np.float64)
    want = np.where(e[..., None] > 0, (texels[..., :3] + 0.5)
                    * np.exp2(e - 136)[..., None], 0.0)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    sky = TX.read_hdr(os.path.join(BENCH, "configs", "assets", "sky.hdr"))
    assert sky.shape == (256, 512, 3) and sky.min() > 0


def test_the_cell_resolves_by_name():
    c = spec.load_cell(CELL)
    assert c.chips == 1 and c.config["name"] == "textured_env"
    assert c.mix == "render_frames_texenv"
    assert hasattr(c.mix_module(), "Mix")
    readers = c.readers()
    assert {"p1_roofline", "texture_load_s", "k2_roofline",
            "torch_kernel_ms.render", "graph_nodes.render"} <= set(readers)
    assert {m["name"] for m in c.end_to_end} == {
        "render_segments_per_s", "peak_mem_gib", "setup_s"}
    assert c.settings["limits"]["image_gap"] > 0


def _fault(monkeypatch, fault):
    """A fault planted in the port's texture, sky or glass shading."""
    from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
    from project3_cuda_path_tracer_tpu_torch.ops.vec import V3
    if fault == "texel_shift":
        # every atlas fetch one texel to the right in its row
        clean = wf._atlas_flat_index

        def shifted(textures, *args, **kwargs):
            flat, textured = clean(textures, *args, **kwargs)
            wa = textures.atlas.shape[1]
            x = flat % wa
            return (flat - x + (x + 1) % wa).to(torch.int32), textured
        monkeypatch.setattr(wf, "_atlas_flat_index", shifted)
    elif fault == "texel_pitch":
        # the atlas addressed with a row pitch one texel too long
        clean = wf._atlas_flat_index

        def off_by_one(textures, *args, **kwargs):
            flat, textured = clean(textures, *args, **kwargs)
            return (flat + flat // textures.atlas.shape[1]).to(
                torch.int32), textured
        monkeypatch.setattr(wf, "_atlas_flat_index", off_by_one)
    elif fault == "sky_black":
        monkeypatch.setattr(wf, "_unpack_rgbe", lambda p, scale: V3(
            *(torch.zeros(p.shape) for _ in range(3))))
    else:   # Fresnel's reflectance a fixed split of about one half
        monkeypatch.setattr(wf, "_pow5", lambda x: torch.full_like(x, 0.5))


@pytest.mark.parametrize("fault,view", [("none", "published"),
                                        ("none", "glass"),
                                        ("texel_shift", "published"),
                                        ("texel_pitch", "published"),
                                        ("sky_black", "published"),
                                        ("fresnel_split", "glass")])
def test_planted_faults_fail_the_check(monkeypatch, tmp_path, fault, view):
    """A whole run of the cut (set-up, window, check), as on the card: a
    sound port is correct, each planted fault is not."""
    if fault != "none":
        _fault(monkeypatch, fault)
    out = runner.run(_cell(tmp_path, view), 2 ** 31 + 21, 0.2, False, CPU,
                     0.0)
    assert out["correct"] is (fault == "none"), out["checks"]
    if fault != "none":
        assert out["failed"] == out["attempted"]


@pytest.mark.parametrize("view", ["published", "glass"])
def test_the_control_fails(tmp_path, view):
    c = _cell(tmp_path, view)
    nums = control_texenv.render_numbers(c, 2 ** 31 + 9, 12, CPU)
    assert nums["image_gap"] > c.settings["limits"]["image_gap"]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, 'portbench'); "
            "import control_texenv, reference.texenv, harness.roofline_tex; "
            "from harness import guard; print(guard.loaded())")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"
