"""Textures of the torch port (slice D) against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
and its port counterpart. Tolerances:
  - bit for bit: the image readers and packers (utils/image.py), every
    field of the parsed Textures (textured_env, textured_env_proc, and a
    scene with BUMP and NORMALMAP as in tests/test_bump.py), the atlas pair
    plane, the fetch helpers' indices and the atlas fractions;
  - the env fractions to one float32 ulp of the texel coordinate (they
    come from atan2 and acos, whose last bit differs between torch and
    XLA; the indices agree);
  - 1e-6 absolute: the unpacked texels;
  - the lane contract (ROADMAP "How a part is held", tests/
    test_torch_megakernel.py): lanes agree to 1e-4, at most 1% diverge,
    means within 0.05, for intersect_planar(tangents=True) on cubes,
    spheres and the torus, and shade_planar with injected uniforms in each
    fetch branch, with the bump and with the normal map.
The texel fetches here run on CPU tensors, so ops/texfetch.take_u32 takes
P1's plain version (ops/texfetch.gather_plain); the card's kernel is
held against it in tests/test_torch_cuda.py and chip_smoke.py.
Whole iterations are in tests/test_torch_textured_render.py.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.ops import wavefront as jwf
from project3_cuda_path_tracer_tpu.ops.vec import V3 as JV3
from project3_cuda_path_tracer_tpu.scene import parser as jparser
from project3_cuda_path_tracer_tpu.utils import image as jimg
from project3_cuda_path_tracer_tpu_torch import load_scene
from project3_cuda_path_tracer_tpu_torch.ops import texfetch
from project3_cuda_path_tracer_tpu_torch.ops import wavefront as wf
from project3_cuda_path_tracer_tpu_torch.ops.vec import V3
from project3_cuda_path_tracer_tpu_torch.render import integrator as PI
from project3_cuda_path_tracer_tpu_torch.scene import parser as pparser
from project3_cuda_path_tracer_tpu_torch.scene.convert import \
    textures_from_numpy
from project3_cuda_path_tracer_tpu_torch.utils.launches import launch_counts
from project3_cuda_path_tracer_tpu_torch.utils import image as pimg
from test_torch_megakernel import assert_lane_contract

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
ASSETS = os.path.join(SCENES, "assets")
N = 4096

# tests/test_bump.py's scene: a sphere under a light, its material bumped
# and normal-mapped
BUMP_SCENE = """MATERIAL 0
RGB .8 .7 .6
BUMP 0.5 7
NORMALMAP nm.png

MATERIAL 1
RGB 1 1 1
EMITTANCE 8

CAMERA
RES 48 48
FOVY 45
ITERATIONS 8
DEPTH 4
FILE b
EYE 0 0 6
LOOKAT 0 0 0
UP 0 1 0

OBJECT 0
sphere
material 0
TRANS 0 0 0
ROTAT 0 0 0
SCALE 3 3 3

OBJECT 1
cube
material 1
TRANS 0 4.5 3
ROTAT 0 0 0
SCALE 3 .1 3
"""


def normal_map_png(path, seed=1, side=16):
    """A tangent-space normal map of random tilts (blue-dominant)."""
    rng = np.random.default_rng(seed)
    nm = np.empty((side, side, 3), np.uint8)
    nm[..., :2] = rng.integers(40, 216, (side, side, 2))
    nm[..., 2] = rng.integers(180, 256, (side, side))
    jimg.write_png(str(path), nm)


def bump_scene_path(tmp_path) -> str:
    normal_map_png(tmp_path / "nm.png")
    path = tmp_path / "bump.txt"
    path.write_text(BUMP_SCENE)
    return str(path)


def scene_path(tmp_path, name) -> str:
    if name == "bump":
        return bump_scene_path(tmp_path)
    return os.path.join(SCENES, name + ".txt")


@pytest.fixture(scope="module")
def textured():
    """(JAX scene, port scene) of scenes/textured_env.txt."""
    path = os.path.join(SCENES, "textured_env.txt")
    return jax_load_scene(path), load_scene(path)


def jax_fields(tx) -> dict:
    return {f.name: np.asarray(getattr(tx, f.name))
            for f in dataclasses.fields(tx)}


def to_port(jtx):
    """The port's Textures of a JAX Textures, with its fused tables."""
    return texfetch.fuse(textures_from_numpy(jax_fields(jtx)))


def assert_bits(got: torch.Tensor, want, what=""):
    g = got.numpy()
    w = np.asarray(want)
    if w.dtype == np.uint32:
        g = g.view(np.uint32)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype,
                                                       w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


# ---------------------------------------------------------------------------
# utils/image.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["checker.png", "sky.hdr", "normal_map"])
def test_image_readers_match_jax(name, tmp_path):
    """read_png, read_hdr and read_image give the JAX arrays bit for bit
    (the two assets, and a PNG the writer made)."""
    if name == "normal_map":
        path = tmp_path / "nm.png"
        normal_map_png(path, side=12)
        path = str(path)
    else:
        path = os.path.join(ASSETS, name)
    reader = {"png": "read_png", "hdr": "read_hdr"}[path.rsplit(".", 1)[1]]
    want = getattr(jimg, reader)(path)
    got = getattr(pimg, reader)(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pimg.read_image(path), want)


def _packer_inputs():
    rng = np.random.default_rng(11)
    ldr = rng.integers(0, 256, (9, 13, 3)).astype(np.float32) / 255.0
    hdr = (rng.uniform(0, 1, (7, 16, 3)) ** 3 * 80.0).astype(np.float32)
    hdr[2, 5] = 0.0
    hdr[3, 15] = 1e-38
    return dict(ldr=ldr, hdr=hdr, checker=jimg.read_png(
        os.path.join(ASSETS, "checker.png")), sky=jimg.read_hdr(
        os.path.join(ASSETS, "sky.hdr")))


@pytest.mark.parametrize("packer,image", [
    ("pack_rgb8", "ldr"), ("pack_rgb8", "checker"),
    ("pack_565_pair", "ldr"), ("pack_565_pair", "checker"),
    ("pack_rgbe", "hdr"), ("pack_rgbe", "sky"),
    ("pack_env_pair", "hdr"), ("pack_env_pair", "sky")])
def test_packers_match_jax(packer, image):
    """Every packer (and unpack_env_pair of pack_env_pair) bit for bit."""
    img = _packer_inputs()[image]
    want = getattr(jimg, packer)(img)
    got = getattr(pimg, packer)(img)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if packer == "pack_env_pair":
        for g, w in zip(pimg.unpack_env_pair(got),
                        jimg.unpack_env_pair(want)):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# scene/parser.py, scene/convert.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["textured_env", "textured_env_proc",
                                  "bump"])
def test_parsed_textures_match_jax(name, tmp_path):
    """Every Textures field of the JAX parser, bit for bit: the atlas
    strip, rects, ids, env map, checker, sky, bump, normal-map rows and the
    packed planes (uint32 values as int32 bits); the absent planes (1,)."""
    path = scene_path(tmp_path, name)
    jtx = jax_load_scene(path).textures
    ptx = load_scene(path).textures
    for f in dataclasses.fields(jtx):
        assert_bits(getattr(ptx, f.name), getattr(jtx, f.name), f.name)
    conv = textures_from_numpy(jax_fields(jtx))
    for f in dataclasses.fields(jtx):
        assert torch.equal(getattr(conv, f.name), getattr(ptx, f.name))
    if name == "textured_env":
        assert ptx.atlas.shape == (512, 512, 3) and ptx.env.shape == (
            256, 512, 3)
        assert ptx.atlas_packed.numel() == 512 * 512
        assert ptx.env_packed.numel() == 512 * 256


@pytest.mark.parametrize("name", ["textured_env", "bump"])
def test_build_atlas_pair_matches_jax(name, tmp_path):
    """The --bilinear-fast RGB565 pair plane, bit for bit, and its lazy
    build in build_trace_config (with the env's pair plane)."""
    path = scene_path(tmp_path, name)
    js, ps = jax_load_scene(path), load_scene(path)
    assert_bits(pparser.build_atlas_pair(ps.textures),
                jparser.build_atlas_pair(js.textures))
    assert ps.textures.atlas_pair.shape == (1,)
    ps.settings.bilinear = ps.settings.bilinear_fast = True
    cfg = PI.build_trace_config(ps)
    assert cfg.bilinear and cfg.bilinear_fast
    assert_bits(ps.textures.atlas_pair,
                jparser.build_atlas_pair(js.textures))
    if name == "textured_env":
        assert_bits(ps.textures.env_pair,
                    jimg.pack_env_pair(np.asarray(js.textures.env)))
    assert pparser.build_atlas_pair(
        load_scene(os.path.join(SCENES, "cornell.txt")).textures) is None


# ---------------------------------------------------------------------------
# the fetch helpers
# ---------------------------------------------------------------------------

def _lookups(seed=0, n=N):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n))
    d[:, :4] = [[0, 0, 1e-8, 0], [1, -1, 1.0, 0], [0, 0, 1e-8, -1]]
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    u = rng.uniform(-2, 3, n).astype(np.float32)
    v = rng.uniform(-2, 3, n).astype(np.float32)
    u[:4] = [0.0, 1e-4, 0.999, 1.0 - 1e-7]
    mat = rng.integers(0, 4, n).astype(np.int32)
    return d, u, v, mat


def test_fetch_indices_match_jax(textured):
    """_atlas_flat_index, _atlas_bilinear_indices, _env_flat_index and
    _env_bilinear_indices: indices, atlas fractions and masks bit for bit;
    env fractions to one float32 ulp of the texel coordinate."""
    js, ps = textured
    d, u, v, mat = _lookups()
    jd = JV3(*(jnp.asarray(c) for c in d))
    pd = V3(*(torch.from_numpy(c) for c in d))
    jm, pm = jnp.asarray(mat), torch.from_numpy(mat).long()
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    pu, pv = torch.from_numpy(u), torch.from_numpy(v)
    jt, pt = js.textures, ps.textures
    for got, want in (
            (wf._atlas_flat_index(pt, pm, pu, pv),
             jwf._atlas_flat_index(jt, jm, ju, jv)),
            (wf._atlas_flat_index(pt, pm, pu, pv, rect=pt.nrm_rect,
                                  tid_table=pt.nrm_id),
             jwf._atlas_flat_index(jt, jm, ju, jv, rect=jt.nrm_rect,
                                   tid_table=jt.nrm_id)),
            (wf._atlas_bilinear_indices(pt, pm, pu, pv),
             jwf._atlas_bilinear_indices(jt, jm, ju, jv)),
            ((wf._env_flat_index(pt, pd),), (jwf._env_flat_index(jt, jd),)),
            (wf._env_bilinear_indices(pt, pd)[:4],
             jwf._env_bilinear_indices(jt, jd)[:4])):
        for g, w in zip(got, want):
            assert_bits(g, w)
    we, he = pt.env.shape[1], pt.env.shape[0]
    gfu, gfv = wf._env_bilinear_indices(pt, pd)[4:]
    wfu, wfv = jwf._env_bilinear_indices(jt, jd)[4:]
    assert np.abs(gfu.numpy() - np.asarray(wfu)).max() <= np.spacing(
        np.float32(we))
    assert np.abs(gfv.numpy() - np.asarray(wfv)).max() <= np.spacing(
        np.float32(he))


def test_unpacked_texels_match_jax(textured):
    """The decodes of the packed planes (RGB8, RGBE, RGB565 pairs, env
    pairs) and the bilerp to 1e-6, fetched from the scene's own tables."""
    js, ps = textured
    rng = np.random.default_rng(2)
    jt = dataclasses.replace(
        js.textures,
        atlas_pair=jparser.build_atlas_pair(js.textures),
        env_pair=jnp.asarray(jimg.pack_env_pair(np.asarray(js.textures.env))))
    pt = to_port(jt)
    na, ne = 512 * 512, 512 * 256
    ia = rng.integers(0, na, N).astype(np.int32)
    ie = rng.integers(0, ne, N).astype(np.int32)
    fu = rng.random(N, dtype=np.float32)
    fv = rng.random(N, dtype=np.float32)
    take_j = lambda t, i: jnp.take(t, jnp.asarray(i))  # noqa: E731
    take_p = lambda t, i: texfetch.take_u32(t, torch.from_numpy(i))  # noqa

    def close(got, want):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)
    close(wf._unpack_rgb8(take_p(pt.atlas_packed, ia)),
          jwf._unpack_rgb8(take_j(jt.atlas_packed, ia)))
    close(wf._unpack_rgbe(take_p(pt.env_packed, ie), pt.env_enabled),
          jwf._unpack_rgbe(take_j(jt.env_packed, ie), jt.env_enabled))
    for got, want in zip(wf._unpack_565pair(take_p(pt.atlas_pair, ia)),
                         jwf._unpack_565pair(take_j(jt.atlas_pair, ia))):
        close(got, want)
    for got, want in zip(
            wf._unpack_envpair(take_p(pt.env_pair, ie), pt.env_enabled),
            jwf._unpack_envpair(take_j(jt.env_pair, ie), jt.env_enabled)):
        close(got, want)
    corners = [wf._unpack_rgb8(take_p(pt.atlas_packed, np.roll(ia, k)))
               for k in range(4)]
    jcorners = [jwf._unpack_rgb8(take_j(jt.atlas_packed, np.roll(ia, k)))
                for k in range(4)]
    close(wf._bilerp(*corners, torch.from_numpy(fu), torch.from_numpy(fv)),
          jwf._bilerp(*jcorners, jnp.asarray(fu), jnp.asarray(fv)))
    # the packed RGB8 texels equal the float32 atlas they were made from
    close(wf._unpack_rgb8(take_p(pt.atlas_packed, ia)),
          [pt.atlas.reshape(-1, 3)[torch.from_numpy(ia).long(), c]
           for c in range(3)])


def test_sample_texture_and_env_match_jax(textured):
    """_sample_texture_planar and _sample_env_planar (one packed take
    each), and their three-take float32 form where the packed planes are
    absent, to 1e-6 except where an env lookup lands on a neighbour texel
    (the ulp of atan2 above; at most 0.1% of the lanes)."""
    js, ps = textured
    d, u, v, mat = _lookups(3)
    base = np.full((3, N), 0.25, np.float32)
    nopack = dataclasses.replace(js.textures,
                                 atlas_packed=jnp.zeros((1,), jnp.uint32),
                                 env_packed=jnp.zeros((1,), jnp.uint32))
    for jt in (js.textures, nopack):
        pt = to_port(jt)
        got = wf._sample_texture_planar(
            pt, torch.from_numpy(mat).long(), torch.from_numpy(u),
            torch.from_numpy(v), V3(*(torch.from_numpy(c) for c in base)))
        want = jwf._sample_texture_planar(
            jt, jnp.asarray(mat), jnp.asarray(u), jnp.asarray(v),
            JV3(*(jnp.asarray(c) for c in base)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)
        got = wf._sample_env_planar(pt, V3(*(torch.from_numpy(c)
                                             for c in d)))
        want = jwf._sample_env_planar(jt, JV3(*(jnp.asarray(c) for c in d)))
        bad = np.zeros(N, bool)
        for g, w in zip(got, want):
            bad |= np.abs(g.numpy() - np.asarray(w)) > 1e-6
        assert bad.mean() <= 0.001


def test_take_u32_routes_through_p1():
    """take_u32 is P1's gather: on CPU tensors its plain version (no
    launch counted); a wrong index dtype, a strided index or a wrong table
    type raises instead of falling back; take_f32 carries float bits."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, 1000,
                                          dtype=np.int64).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 1000, 257).astype(np.int32))
    before = launch_counts()
    got = texfetch.take_u32(table, idx)
    assert launch_counts() == before
    assert torch.equal(got, table[idx.long()])
    assert torch.equal(got, texfetch.gather_plain(table, idx))
    f = torch.from_numpy(rng.random(1000, dtype=np.float32))
    assert torch.equal(texfetch.take_f32(f, idx), f[idx.long()])
    with pytest.raises(TypeError):
        texfetch.take_u32(table, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        texfetch.take_u32(table, torch.stack([idx, idx], 1)[:, 0])
    with pytest.raises(TypeError):
        texfetch.take_u32(table.float(), idx)


def test_fuse_builds_the_fused_tables_once(textured):
    """fuse concatenates the atlas and env planes (env from Ha*Wa on), the
    Renderer's device textures carry them, and the shader refuses to run a
    fused branch without them rather than concatenating per bounce."""
    _, ps = textured
    tx = ps.textures
    fused = texfetch.fuse(tx)
    assert torch.equal(fused.fused_packed,
                       torch.cat([tx.atlas_packed, tx.env_packed]))
    assert fused.fused_pair.shape == (1,)
    assert texfetch.fuse(load_scene(os.path.join(
        SCENES, "cornell.txt")).textures).fused_packed.shape == (1,)
    z = torch.zeros(4)
    d = V3(z, z + 1.0, z)
    hit = wf.HitP(t=z, normal=d, mat_id=z.long(), point=d, surf=d, u=z,
                  v=z, outside=z > 0)
    with pytest.raises(ValueError, match="fuse"):
        wf._textured_albedo(hit, d, tx, d, False, False)


# ---------------------------------------------------------------------------
# intersect_planar(tangents=True)
# ---------------------------------------------------------------------------

def _scene_rays(n, seed):
    """Rays from the camera side of textured_env into its objects, a
    quarter of them upward to the sky. numpy [3, N] origins, directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-3.0, 1.0, 5.0], [3.0, 5.0, 9.0], (n, 3))
    target = rng.uniform([-4.0, -0.5, -3.0], [4.0, 3.5, 3.0], (n, 3))
    d = target - o
    up = rng.random(n) < 0.25
    d[up] = rng.normal(size=(int(up.sum()), 3)) + [0.0, 1.5, 0.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.T.astype(np.float32), d.T.astype(np.float32)


def _bump_rays(n, seed):
    """Rays from in front of the bump scene's sphere (radius 1.5 at the
    origin) toward it and past it."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-2.0, -2.0, 4.0], [2.0, 2.0, 7.0], (n, 3))
    target = rng.uniform(-1.8, 1.8, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.T.astype(np.float32), d.T.astype(np.float32)


def _hit_to_port(jh) -> wf.HitP:
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    v3 = lambda a: V3(*(t(c) for c in a))  # noqa: E731
    return wf.HitP(t=t(jh.t), normal=v3(jh.normal),
                   mat_id=t(jh.mat_id).long(), point=v3(jh.point),
                   surf=v3(jh.surf), u=t(jh.u), v=t(jh.v),
                   outside=t(jh.outside),
                   tan=None if jh.tan is None else v3(jh.tan))


def _intersect_both(js, ps, o, d, tangents=True):
    n = o.shape[1]
    gt = tuple(int(x) for x in np.asarray(js.geoms.type))
    mids = tuple(int(x) for x in np.asarray(js.geoms.mesh_id))
    jh = jwf.intersect_planar(JV3(*(jnp.asarray(c) for c in o)),
                              JV3(*(jnp.asarray(c) for c in d)),
                              jnp.zeros(n), js.geoms, js.meshes, gt,
                              js.packed_meshes, mids, tangents=tangents)
    ph = wf.intersect_planar(V3(*(torch.from_numpy(c) for c in o)),
                             V3(*(torch.from_numpy(c) for c in d)),
                             torch.zeros(n), ps.geoms, gt, ps.packed_meshes,
                             mids, meshes=ps.meshes, tangents=tangents)
    return jh, ph


@pytest.mark.parametrize("name", ["textured_env", "bump"])
def test_intersect_uv_and_tangents_match_jax(name, tmp_path, textured):
    """t, normal, uv and the uv tangent of every lane (cube faces, spheres
    and, on textured_env, the torus through its 8-wide BVH) under the lane
    contract."""
    if name == "textured_env":
        js, ps = textured
    else:
        path = bump_scene_path(tmp_path)
        js, ps = jax_load_scene(path), load_scene(path)
    o, d = _scene_rays(N, 6) if name == "textured_env" else _bump_rays(N, 6)
    jh, ph = _intersect_both(js, ps, o, d)
    got = [ph.t, *ph.normal, ph.u, ph.v, *ph.tan]
    want = [jh.t, *jh.normal, jh.u, jh.v, *jh.tan]
    assert_lane_contract(np.stack([g.numpy() for g in got]),
                         np.stack([np.asarray(w) for w in want]))
    np.testing.assert_array_equal(ph.mat_id.numpy(), np.asarray(jh.mat_id))
    hit = ph.t.numpy() > 0
    assert 0.3 < hit.mean() < 0.95
    mats = set(ph.mat_id.numpy()[hit].tolist())
    assert mats >= ({0, 1, 2, 3} if name == "textured_env" else {0})
    assert float(ph.tan.x.abs().max()) > 0


# ---------------------------------------------------------------------------
# shade_planar's texture terms
# ---------------------------------------------------------------------------

def _variant(jtx, kind):
    """The JAX textures of one fetch branch of shade_planar."""
    u32 = jnp.zeros((1,), jnp.uint32)
    pair = jparser.build_atlas_pair(jtx)
    env_pair = jnp.asarray(jimg.pack_env_pair(np.asarray(jtx.env)))
    no_env = dict(env=jnp.zeros((1, 1, 3), jnp.float32),
                  env_enabled=jnp.zeros((), jnp.float32), env_packed=u32)
    no_atlas = dict(atlas=jnp.zeros((1, 1, 3), jnp.float32),
                    tex_id=-jnp.ones_like(jtx.tex_id), atlas_packed=u32)
    return {
        "fused": {}, "fused_bilinear": {},
        "fused_fast": dict(atlas_pair=pair, env_pair=env_pair),
        "fused_fast_atlas_pair": dict(atlas_pair=pair),
        "atlas": no_env, "atlas_bilinear": no_env,
        "atlas_fast": dict(no_env, atlas_pair=pair),
        "env": no_atlas, "env_bilinear": no_atlas,
        "env_fast": dict(no_atlas, env_pair=env_pair),
        "float32": dict(atlas_packed=u32, env_packed=u32),
    }[kind]


BRANCHES = ["fused", "fused_bilinear", "fused_fast", "fused_fast_atlas_pair",
            "atlas", "atlas_bilinear", "atlas_fast", "env", "env_bilinear",
            "env_fast", "float32"]


def _shade_both(jh, ph, d, js, jtx, ps_mats, **kw):
    rng = np.random.default_rng(4)
    thr = rng.uniform(0.1, 1.0, (3, N)).astype(np.float32)
    alive = rng.random(N) < 0.9
    last = rng.random(N) < 0.1
    u = rng.random((4, N), dtype=np.float32)
    jout = jwf.shade_planar(
        jh, JV3(*(jnp.asarray(c) for c in d)),
        JV3(*(jnp.asarray(c) for c in thr)), jnp.asarray(alive),
        js.materials, jtx, jnp.asarray(u), last_bounce=jnp.asarray(last),
        glossy=False, **kw)
    pout = wf.shade_planar(
        ph, V3(*(torch.from_numpy(c) for c in d)),
        V3(*(torch.from_numpy(c) for c in thr)), torch.from_numpy(alive),
        ps_mats, to_port(jtx), torch.from_numpy(u),
        last_bounce=torch.from_numpy(last), glossy=False, **kw)
    for k in ("origin", "direction", "throughput", "radiance"):
        assert_lane_contract(np.stack([c.numpy() for c in getattr(pout, k)]),
                             np.stack([np.asarray(c)
                                       for c in getattr(jout, k)]))
    np.testing.assert_array_equal(pout.alive.numpy(), np.asarray(jout.alive))
    return pout, jout


@pytest.mark.parametrize("branch", BRANCHES)
def test_shade_fetch_branches_match_jax(branch, textured):
    """shade_planar on JAX's hit records with injected uniforms, in each
    fetch branch of the JAX function: the fused atlas+env take (nearest,
    --bilinear, --bilinear-fast with both pair planes or the atlas's
    alone), the atlas alone, the env alone, and the three-take float32
    form, under the lane contract."""
    js, ps = textured
    o, d = _scene_rays(N, 7)
    jh, _ = _intersect_both(js, ps, o, d, tangents=False)
    ph = _hit_to_port(jh)
    jtx = dataclasses.replace(js.textures, **_variant(js.textures, branch))
    kw = dict(bilinear="bilinear" in branch or "fast" in branch,
              bilinear_fast="fast" in branch, sky=False)
    _, jout = _shade_both(jh, ph, d, js, jtx, ps.materials, **kw)
    assert (ph.t.numpy() <= 0).any()
    # the scene has no emitter: only the env map lights a miss
    lit = float(np.asarray(jout.radiance.x).max()) > 0
    assert lit == (not branch.startswith("atlas"))


def test_shade_checker_and_sky_match_jax():
    """textured_env_proc's procedural checker (floor and torus) and its
    procedural sky."""
    path = os.path.join(SCENES, "textured_env_proc.txt")
    js, ps = jax_load_scene(path), load_scene(path)
    o, d = _scene_rays(N, 8)
    jh, _ = _intersect_both(js, ps, o, d, tangents=False)
    pout, jout = _shade_both(jh, _hit_to_port(jh), d, js, js.textures,
                             ps.materials, sky=True)
    checker = pout.throughput.z > pout.throughput.x * 1.5
    assert bool(checker.any())


@pytest.mark.parametrize("feature", ["bump", "nmap", "both"])
def test_shade_bump_and_normal_map_match_jax(feature, tmp_path):
    """The procedural bump and the tangent-space normal map (its texel
    through the atlas, its frame from the intersect stage's tangents, the
    fallback frame and the hemisphere guard) under the lane contract; each
    moves the shading against the plain normal."""
    path = bump_scene_path(tmp_path)
    js, ps = jax_load_scene(path), load_scene(path)
    o, d = _bump_rays(N, 9)
    jh, _ = _intersect_both(js, ps, o, d)
    ph = _hit_to_port(jh)
    kw = dict(bump=feature in ("bump", "both"),
              nmap=feature in ("nmap", "both"), sky=False)
    pout, _ = _shade_both(jh, ph, d, js, js.textures, ps.materials, **kw)
    plain, _ = _shade_both(jh, ph, d, js, js.textures, ps.materials,
                           sky=False)
    moved = (pout.direction.x - plain.direction.x).abs() > 1e-3
    assert float(moved.float().mean()) > 0.05


# ---------------------------------------------------------------------------
# configuration, the train step's refusal, the CLI
# ---------------------------------------------------------------------------

def _spheres_scene(textured_mats) -> str:
    mats, objs = [], []
    for i in range(10):
        extra = "CHECKER 4 0 0 0\n" if i in textured_mats else ""
        mats.append(f"MATERIAL {i}\nRGB .5 .5 .5\n{extra}")
        objs.append(f"OBJECT {i}\nsphere\nmaterial {i}\nTRANS {i} 0 0\n"
                    "ROTAT 0 0 0\nSCALE .5 .5 .5\n")
    cam = ("CAMERA\nRES 8 8\nFOVY 40\nITERATIONS 1\nDEPTH 2\nFILE s\n"
           "EYE 0 3 10\nLOOKAT 0 0 0\nUP 0 1 0\n")
    return "\n".join(mats) + "\n" + cam + "\n" + "\n".join(objs)


@pytest.mark.parametrize("textured_mats", [(), (3,), (1, 4)])
def test_eligible_sphere_batch_leaves_out_textured(textured_mats, tmp_path):
    """The batched sphere pass leaves out spheres whose material is
    checkered (no uv there), as the JAX rule does; below
    SPHERE_BATCH_MIN eligible spheres there is no batch."""
    from project3_cuda_path_tracer_tpu.render import integrator as JI
    path = tmp_path / "spheres.txt"
    path.write_text(_spheres_scene(textured_mats))
    js, ps = jax_load_scene(str(path)), load_scene(str(path))
    want = JI._eligible_sphere_batch(js)
    assert PI._eligible_sphere_batch(ps) == want
    assert want == (tuple(g for g in range(10) if g not in textured_mats)
                    if len(textured_mats) <= 1 else ())


def test_train_step_refuses_textured_scenes(textured):
    """The train step no longer refuses a textured scene: InverseRenderer
    builds its config with the scene's texture fields and fused tables
    (the gradients against jax.grad: tests/test_torch_train_textured.py)."""
    from project3_cuda_path_tracer_tpu_torch.models.inverse import \
        InverseRenderer
    _, ps = textured
    w, h = ps.camera.resolution
    inv = InverseRenderer(ps, np.zeros((h, w, 3), np.float32),
                          device="cpu")
    assert inv.cfg.bump == bool((ps.textures.bump[:, 0] > 0).any())
    assert inv.cfg.nmap == bool((ps.textures.nrm_id >= 0).any())
    assert inv.cfg.sky == bool(float(ps.textures.sky[0]) > 0)


def small_textured_copy(tmp_path, res=16, name="textured_env") -> str:
    """scenes/<name>.txt at res x res beside its assets' absolute paths."""
    with open(os.path.join(SCENES, name + ".txt")) as f:
        text = f.read()
    text = (text.replace("RES         2048 2048", f"RES         {res} {res}")
            .replace("assets/", os.path.join(SCENES, "assets") + "/")
            .replace("meshes/", os.path.join(SCENES, "meshes") + "/"))
    assert f"RES         {res} {res}" in text
    path = tmp_path / f"{name}_{res}.txt"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("flags", [["--bilinear-fast", "--nee"],
                                   ["--bilinear", "--stratified"]])
def test_cli_textured_scene(flags, tmp_path, capsys):
    """The CLI on a 16x16 copy of textured_env: --bilinear and
    --bilinear-fast are taken (no exit 2), the render takes the wavefront
    route and writes a PNG."""
    import json
    from project3_cuda_path_tracer_tpu_torch.app import cli
    scene = small_textured_copy(tmp_path)
    rc = cli.main([scene, "--device", "cpu", "--iterations", "2", "--depth",
                   "2", "--outdir", str(tmp_path), "--out", "tex",
                   "--metrics", *flags])
    err = capsys.readouterr().err
    assert rc == 0, err
    png = tmp_path / "tex.png"
    assert png.exists() and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "route=wavefront" in err and "features dropped" not in err
    assert json.loads(err.strip().splitlines()[-1])["iters"] == 2
