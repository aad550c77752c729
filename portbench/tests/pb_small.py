"""Small cells for the CPU tests: a cell of BENCHMARK.json with its scene cut
to a few pixels and bounces, and a tiny mesh."""
from __future__ import annotations

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (BENCH, os.path.dirname(BENCH))
                if p not in sys.path]

from harness import spec  # noqa: E402


def scene_lines(lines, res, depth):
    out = []
    for line in lines:
        tok = line.split()
        if tok and tok[0] == "RES":
            line = "RES %d %d" % res
        elif tok and tok[0] == "DEPTH":
            line = "DEPTH %d" % depth
        out.append(line)
    return out


def cell(name, res=(16, 12), depth=3, **settings):
    c = spec.load_cell(name)
    c.config = dict(c.config, scene=scene_lines(c.config["scene"], res,
                                                depth))
    c.settings = dict(c.settings, **settings)
    return c


OCTAHEDRON = """v 1 0 0
v -1 0 0
v 0 1 0
v 0 -1 0
v 0 0 1
v 0 0 -1
vn 1 0 0
vn -1 0 0
vn 0 1 0
vn 0 -1 0
vn 0 0 1
vn 0 0 -1
f 1//1 3//3 5//5
f 3//3 2//2 5//5
f 2//2 4//4 5//5
f 4//4 1//1 5//5
f 3//3 1//1 6//6
f 2//2 3//3 6//6
f 4//4 2//2 6//6
f 1//1 4//4 6//6
"""


def tiny_mesh_cell(tmp_path, res=(12, 10), depth=4):
    """The mesh cell with its OBJ swapped for an octahedron."""
    obj = tmp_path / "octa.obj"
    obj.write_text(OCTAHEDRON)
    c = cell("mesh-render", res, depth)
    c.config = dict(c.config, meshes={k: str(obj) for k in
                                      c.config["meshes"]})
    return c
