"""The torch port's BVH build, packing and plain traversals against the JAX
package.

`scene/bvh.py` must build the JAX package's tree bit for bit, and the packers
(`ops/bvh8.pack_mesh8`, `ops/pallas_bvh.pack_mesh`) its tables. The plain
versions of the traversal kernels (`traverse8_plain` for K2,
`traverse_binary_plain` for K3/K4) are held against the Pallas kernels in
interpret mode, as tests/test_bvh8.py runs them, and against a brute-force
Moller-Trumbore over every triangle. The CUDA kernels need a card:
tests/test_torch_cuda.py and chip_smoke.py hold them against the plain
versions.

The blob (81,920 triangles) is built once, by the JAX parser, and carried
over (`mesh_bundle_from_numpy`); the torus (12,288 faces) is built by both.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import load_scene as jax_load_scene
from project3_cuda_path_tracer_tpu.ops import bvh8 as J8
from project3_cuda_path_tracer_tpu.ops import pallas_bvh as JPB
from project3_cuda_path_tracer_tpu.scene import bvh as JB
from project3_cuda_path_tracer_tpu_torch.ops import bvh8 as P8
from project3_cuda_path_tracer_tpu_torch.ops import pallas_bvh as PPB
from project3_cuda_path_tracer_tpu_torch.scene import bvh as PB
from project3_cuda_path_tracer_tpu_torch.utils.launches import launch_counts
from project3_cuda_path_tracer_tpu_torch.scene.convert import (
    mesh_bundle_from_numpy, packed_mesh_from_numpy)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORUS = os.path.join(REPO, "scenes", "meshes", "torus.obj")
KINDS = ["bvh8", "binary"]


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype != np.uint8 else a


def _assert_bitwise(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _bundle_dict(b):
    return {f.name: np.asarray(getattr(b, f.name))
            for f in dataclasses.fields(b)}


@pytest.fixture(scope="module")
def blob():
    """(JAX mesh.txt scene, the port's MeshBundle carried over from it)."""
    js = jax_load_scene(os.path.join(REPO, "scenes", "mesh.txt"))
    return js, mesh_bundle_from_numpy(_bundle_dict(js.meshes))


@pytest.fixture(scope="module")
def torus():
    """(JAX bundle, port bundle), each built by its own package."""
    return (JB.build_mesh_bundle([TORUS]), PB.build_mesh_bundle([TORUS]))


def _packed(kind, bundle):
    pack = P8.pack_mesh8 if kind == "bvh8" else PPB.pack_mesh
    return pack(bundle, 0)


def _traverse_plain(kind, qo, qd, packed, t_bound=None):
    return _traverse_counted(kind, qo, qd, packed, t_bound)[:5]


def _traverse_counted(kind, qo, qd, packed, t_bound=None):
    """The plain version's outputs and its per-ray count: K2's pops, or
    K3/K4's node visits."""
    if kind == "bvh8":
        return P8.traverse8_plain(qo, qd, packed, t_bound)
    return PPB.traverse_binary_plain(qo, qd, packed, t_bound)


def _aimed_rays(n, seed=0):
    """Rays from random origins on a radius-3 sphere aimed near the centre
    (the generator of tests/test_bvh8.py), as numpy [3, N]."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n)).astype(np.float32)
    o /= np.linalg.norm(o, axis=0, keepdims=True)
    o *= 3.0
    target = rng.uniform(-0.4, 0.4, size=(3, n)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def _torch(planes):
    return tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in planes)


def test_load_obj_matches_jax():
    for got, want in zip(PB._load_obj_py(TORUS), JB._load_obj_py(TORUS)):
        _assert_bitwise(got, want, "load_obj")
    assert PB.load_obj(TORUS)[0].shape == (12288, 3, 3)


def test_build_bvh_matches_jax():
    verts = PB._load_obj_py(TORUS)[0]
    for i, (got, want) in enumerate(zip(PB._build_bvh_py(verts),
                                        JB._build_bvh_py(verts))):
        _assert_bitwise(got, want, f"build_bvh output {i}")


def test_mesh_bundle_matches_jax(torus):
    jb, pb = torus
    want = _bundle_dict(jb)
    for name, got in _bundle_dict(pb).items():
        _assert_bitwise(got, want[name], name)


def test_mesh_bundle_from_numpy_is_exact(blob):
    js, pb = blob
    want = _bundle_dict(js.meshes)
    for name, got in _bundle_dict(pb).items():
        _assert_bitwise(got, want[name], name)


@pytest.mark.parametrize("kind", KINDS)
def test_pack_matches_jax(kind, torus, blob):
    """Packing the same tree gives the JAX tables bit for bit: the torus
    built by each package, and the blob carried over."""
    js, blob_bundle = blob
    cases = [(torus[1], torus[0]), (blob_bundle, js.meshes)]
    for port_bundle, jax_bundle in cases:
        got = _packed(kind, port_bundle)
        if kind == "bvh8":
            want = J8.pack_mesh8(jax_bundle, 0)
            fields = ("nodes", "tris")
        else:
            want = JPB.pack_mesh(jax_bundle, 0)
            fields = ("nodes_f", "nodes_i", "tris")
        for f in fields:
            _assert_bitwise(getattr(got, f).numpy(), getattr(want, f), f)


def test_fused_node_rows_match_jax_tables(torus, blob):
    """The kernels' fused node rows hold the JAX tables' box (nodes_f cols
    0-5) and skip and meta (nodes_i cols 0-1) bit for bit, whether packed
    by the port or carried over from the JAX package."""
    js, blob_bundle = blob
    for port_bundle, jax_bundle in ((torus[1], torus[0]),
                                    (blob_bundle, js.meshes)):
        want = JPB.pack_mesh(jax_bundle, 0)
        carried = packed_mesh_from_numpy(
            {f: np.asarray(getattr(want, f)) for f in want._fields})
        for packed in (_packed("binary", port_bundle), carried):
            nodes = packed.nodes.numpy()
            assert nodes.shape == (want.nodes_f.shape[0], 8)
            _assert_bitwise(nodes[:, :6], np.asarray(want.nodes_f)[:, :6],
                            "box")
            _assert_bitwise(nodes[:, 6:].view(np.int32),
                            np.asarray(want.nodes_i)[:, :2], "skip, meta")


def test_pack_all8_matches_parser_default(blob):
    """The JAX parser packs with pack_all8; the port's pack_all8 of the
    carried bundle gives the same fused table."""
    js, pb = blob
    (got,) = P8.pack_all8(pb)
    _assert_bitwise(got.nodes.numpy(), js.packed_meshes[0].nodes, "nodes")
    # every triangle is in exactly one leaf
    enc = got.nodes[:, 48:56].numpy().astype(np.int64)
    metas = -enc[enc <= -2] - 2
    cover = np.zeros(pb.tri_v0.shape[0], np.int32)
    for meta in metas:
        cover[meta // 32: meta // 32 + meta % 32] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("kind", KINDS)
def test_plain_traversal_matches_jax(kind, blob):
    """2,048 aimed rays at the blob: the plain version against the Pallas
    kernel in interpret mode (traverse_packets8 / traverse_packets)."""
    js, pb = blob
    o, d = _aimed_rays(2048)
    jo, jd = (tuple(jnp.asarray(c) for c in a) for a in (o, d))
    if kind == "bvh8":
        want = J8.traverse_packets8(jo, jd, js.packed_meshes[0])
    else:
        want = JPB.traverse_packets(jo, jd, JPB.pack_mesh(js.meshes, 0))
    got = _traverse_plain(kind, _torch(o), _torch(d), _packed(kind, pb))
    jt, jn, ju, jv, jtri = (np.asarray(want[0]), [np.asarray(c)
                                                  for c in want[1]],
                            np.asarray(want[2]), np.asarray(want[3]),
                            np.asarray(want[4]))
    tri = got[4].numpy()
    hit = jtri >= 0
    assert hit.sum() > 1500
    np.testing.assert_array_equal(tri, jtri)
    np.testing.assert_allclose(got[0].numpy()[hit], jt[hit], rtol=1e-5)
    for g, w in zip(got[1], jn):
        np.testing.assert_allclose(g.numpy()[hit], w[hit], atol=1e-4)
    np.testing.assert_allclose(got[2].numpy()[hit], ju[hit], atol=1e-4)
    np.testing.assert_allclose(got[3].numpy()[hit], jv[hit], atol=1e-4)


def _brute_force(o, d, bundle):
    """Nearest hit over every triangle, Moller-Trumbore in float64 with
    the kernels' thresholds: (t [N], tri [N], -1 = miss)."""
    v0 = bundle.tri_v0.double().numpy()
    e1 = bundle.tri_e1.double().numpy()
    e2 = bundle.tri_e2.double().numpy()
    ro, rd = o.T.astype(np.float64), d.T.astype(np.float64)
    pv = np.cross(rd[:, None, :], e2[None])
    det = np.einsum("tk,ntk->nt", e1, pv)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tv = ro[:, None, :] - v0[None]
    bu = np.einsum("ntk,ntk->nt", tv, pv) * inv
    qv = np.cross(tv, e1[None])
    bv = np.einsum("nk,ntk->nt", rd, qv) * inv
    t = np.einsum("tk,ntk->nt", e2, qv) * inv
    hit = ok & (bu >= 0) & (bv >= 0) & (bu + bv <= 1) & (t > 1e-6)
    t = np.where(hit, t, np.inf)
    tri = np.argmin(t, axis=1)
    best = t[np.arange(len(tri)), tri]
    return best, np.where(np.isfinite(best), tri, -1)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_traversal_matches_brute_force(kind, torus):
    """The torus tree against every triangle: the same nearest hit, bar a
    few lanes that graze an edge (the float64 oracle rounds differently)."""
    pb = torus[1]
    o, d = _aimed_rays(512, seed=5)
    got = _traverse_plain(kind, _torch(o), _torch(d), _packed(kind, pb))
    t_ref, tri_ref = _brute_force(o, d, pb)
    tri = got[4].numpy()
    assert (tri_ref >= 0).sum() > 200
    assert (tri == tri_ref).mean() >= 0.99
    both = (tri == tri_ref) & (tri >= 0)
    np.testing.assert_allclose(got[0].numpy()[both], t_ref[both], rtol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_occlusion_bound_prunes(kind, torus):
    """A bound at half the hit distance turns every hit into a miss that
    keeps t = t_bound (the Pallas kernels' contract)."""
    packed = _packed(kind, torus[1])
    o, d = _torch(_aimed_rays(1024, seed=1)[0]), _torch(
        _aimed_rays(1024, seed=1)[1])
    t, _, _, _, tri = _traverse_plain(kind, o, d, packed)
    hit = tri >= 0
    assert hit.sum() > 300
    bound = torch.where(hit, 0.5 * t, torch.full_like(t, 1e30))
    tb, nrm, u, v, tri_b = _traverse_plain(kind, o, d, packed, bound)
    assert (tri_b[hit] == -1).all()
    assert torch.equal(tb[hit], bound[hit])
    assert all((c[hit] == 0).all() for c in list(nrm) + [u, v])


@pytest.mark.parametrize("kind", KINDS)
def test_dead_lanes_miss(kind, torus):
    """t_bound = -1 marks a dead lane: it never enters a box or a leaf."""
    packed = _packed(kind, torus[1])
    o, d = (_torch(a) for a in _aimed_rays(512, seed=2))
    bound = torch.full((512,), 1e30)
    bound[::2] = -1.0
    t, _, _, _, tri, pops = _traverse_counted(kind, o, d, packed, bound)
    assert (tri[::2] == -1).all() and (t[::2] == -1).all()
    assert (tri[1::2] >= 0).sum() > 100
    assert (pops[::2] == 1).all()
    assert (pops[1::2][tri[1::2] >= 0] > 1).all()


@pytest.mark.parametrize("dead", [-1.0, 0.0, float("nan")])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_dead_lane_record(kind, dead, torus):
    """A dead lane (t_bound <= 0 or NaN) gets exactly the miss record: t =
    t_bound (bit for bit), zero normal and uv, tri -1, one pop (K2) or one
    node visit (K3/K4). The kernels write that record without reading the
    tree."""
    packed = _packed(kind, torus[1])
    o, d = (_torch(a) for a in _aimed_rays(256, seed=8))
    bound = torch.full((256,), 1e30)
    bound[::3] = dead
    t, nrm, u, v, tri, pops = _traverse_counted(kind, o, d, packed, bound)
    if kind == "bvh8":
        for any_hit in (False, True):
            occl = P8.traverse8_plain(o, d, packed, bound, any_hit=any_hit)
            assert torch.equal(occl[5][::3],
                               torch.ones(86, dtype=torch.int32))
    np.testing.assert_array_equal(t[::3].numpy().view(np.int32),
                                  bound[::3].numpy().view(np.int32))
    assert all((c[::3] == 0).all() for c in list(nrm) + [u, v])
    assert (tri[::3] == -1).all() and (pops[::3] == 1).all()
    assert (tri[1::3] >= 0).sum() > 40


def test_any_hit_matches_nearest_hit_mask(blob):
    """Occlusion mode reports a hit exactly where nearest-hit does, and
    where the JAX kernel's any_hit mode does; it pops no more nodes."""
    js, pb = blob
    o, d = _aimed_rays(2048, seed=4)
    packed = P8.pack_mesh8(pb, 0)
    near = P8.traverse8_plain(_torch(o), _torch(d), packed)
    occl = P8.traverse8_plain(_torch(o), _torch(d), packed, any_hit=True)
    jtri = J8.traverse_packets8(tuple(jnp.asarray(c) for c in o),
                                tuple(jnp.asarray(c) for c in d),
                                js.packed_meshes[0], any_hit=True)[4]
    np.testing.assert_array_equal((occl[4] >= 0).numpy(),
                                  (near[4] >= 0).numpy())
    np.testing.assert_array_equal((occl[4] >= 0).numpy(),
                                  np.asarray(jtri) >= 0)
    assert (occl[5] <= near[5]).all() and occl[5].sum() < near[5].sum()


@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_takes_plain_path_on_cpu(kind, torus):
    packed = _packed(kind, torus[1])
    o, d = (_torch(a) for a in _aimed_rays(256, seed=3))
    before = launch_counts()
    if kind == "bvh8":
        got = P8.traverse8(o, d, packed, return_pops=True)
        want = P8.traverse8_plain(o, d, packed)
    else:
        assert len(PPB.traverse(o, d, packed, sub_packets=True)) == 5
        got = PPB.traverse(o, d, packed, sub_packets=True,
                           return_steps=True)
        want = PPB.traverse_binary_plain(o, d, packed)
    assert torch.equal(got[5], want[5])
    assert launch_counts() == before
    assert torch.equal(got[4], want[4]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("bad", ["dtype", "shape", "planes", "table"])
@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_rejects_bad_inputs(kind, bad, torus):
    packed = _packed(kind, torus[1])
    o, d = (_torch(a) for a in _aimed_rays(64))
    tb = None
    if bad == "dtype":
        o = tuple(c.double() for c in o)
    elif bad == "shape":
        tb = torch.ones(63)
    elif bad == "planes":
        d = d[:2]
    else:
        packed = packed._replace(tris=packed.tris[:, :20].contiguous())
    fn = P8.traverse8 if kind == "bvh8" else PPB.traverse
    with pytest.raises((TypeError, ValueError)):
        fn(o, d, packed, t_bound=tb)


@pytest.mark.parametrize("kind", KINDS)
def test_grid_schedule_refuses_cpu_tensors(kind, torus):
    """The A/B instances are the card's checks only: K2's grid and
    tiny-stack instances and K4's entry raise on CPU tensors (they never
    fall back to the plain version), and so does each kernel's `_launch`
    of its route's instance; no launch is counted."""
    packed = _packed(kind, torus[1])
    o, d = (_torch(a) for a in _aimed_rays(64))
    counts = launch_counts()
    if kind == "bvh8":
        entries = (P8._traverse8_grid, P8._traverse8_tiny,
                   lambda *a: P8._launch("persistent", *a))
    else:
        entries = (lambda *a: PPB._launch("packet", *a),
                   lambda *a: PPB._launch("grid", *a))
    for entry in entries:
        with pytest.raises(ValueError, match="CUDA"):
            entry(o, d, packed)
    assert launch_counts() == counts


@pytest.mark.parametrize("kind", KINDS)
def test_traverse8_cpu_takes_noncontiguous_planes(kind, torus):
    """The wrappers (traverse8, and pallas_bvh.traverse for K3 and K4) on
    CPU tensors equal their plain versions when the planes are strided
    views (columns of [N, 3] blocks), bound included."""
    packed = _packed(kind, torus[1])
    o, d = _aimed_rays(512, seed=9)
    ob = torch.from_numpy(np.ascontiguousarray(o.T))
    db = torch.from_numpy(np.ascontiguousarray(d.T))
    qo, qd = tuple(ob[:, k] for k in range(3)), tuple(db[:, k]
                                                     for k in range(3))
    assert not qo[0].is_contiguous()
    tb = torch.full((1024,), 1e30)[::2]
    tb[::4] = -1.0
    if kind == "bvh8":
        got = P8.traverse8(qo, qd, packed, t_bound=tb, return_pops=True)
    else:
        got = PPB.traverse(qo, qd, packed, t_bound=tb, return_steps=True)
    want = _traverse_counted(kind, _torch(o), _torch(d), packed,
                             tb.contiguous())
    for g, w in zip(got[:1] + got[1] + got[2:], want[:1] + want[1]
                    + want[2:]):
        assert torch.equal(g, w)
    assert (got[4] >= 0).sum() > 150

