"""The hand kernels' work counts and the roofline share."""
import os

import pytest
import torch

import pb_small
from harness import roofline as RF
from reference import scene as RS
from reference import tracer as R


def test_k2_work_counts_bytes_from_the_inputs():
    w = RF.k2_work(lanes=10, live=4, triangles=3)
    assert w == dict(flops=0.0, bytes=10 * 32 + 4 * 24 + 3 * 96)


def test_share_takes_the_larger_bound():
    w = dict(flops=67e12 * 1e-3, bytes=3.35e12 * 2e-3)
    assert RF.least_seconds(w) == (pytest.approx(2e-3), "bytes")
    assert RF.share([w], 4e-3) == (pytest.approx(50.0), "bytes")
    with pytest.raises(ValueError):
        RF.share([w], 0.0)


def test_k2_bytes_from_the_live_rays_of_a_small_mesh(tmp_path):
    c = pb_small.tiny_mesh_cell(tmp_path, res=(8, 6), depth=4)
    from harness import inputs
    path = inputs.write_scene(c.config, 2 ** 31 + 3)
    with open(path) as f:
        sc = RS.parse(f.read(), os.path.dirname(path))
    tab = R.Tables(sc, "cpu")
    pix = torch.arange(48)
    st = {}
    R.trace(tab, pix, R.LatticeDraws(torch.zeros_like(pix), pix), 4,
            stats=st)
    live = st["live"]
    assert live[0] == 48 and len(live) == 4
    assert all(a >= b for a, b in zip(live, live[1:]))
    tris = sum(g.mesh.corners.shape[0] for g in sc.geoms
               if g.kind == RS.MESH)
    assert tris == 8
    works = [RF.k2_work(48, n, tris) for n in live]
    assert works[0]["bytes"] == 48 * 32 + 48 * 24 + 8 * 96
    assert RF.share(works, 1e-3)[1] == "bytes"
