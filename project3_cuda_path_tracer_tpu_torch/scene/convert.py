"""Carry scene parameters over from the JAX package as NumPy arrays.

The JAX package's tables are pytrees of jax arrays; `np.asarray` of each
`Materials`/`Geoms`/`MeshBundle`/`Textures` leaf, of each packed mesh's
fields and of `Camera.flat()` gives plain dicts of NumPy arrays, which this
module turns into the port's `Scene`, `MeshBundle`, `Textures` and packed
meshes without importing jax; the train step's parameters and optax's Adam state come across the
same way. The tests use it to feed both packages the same parameters, the
same BVH and the same optimizer state.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.inverse import RenderParams, param_leaves
from ..models.optim import AdamState
from ..ops.bvh8 import PackedMesh8
from ..ops.pallas_bvh import PackedMesh, fuse_nodes
from . import types as T

_MATERIAL_KEYS = ("color", "specular_exponent", "specular_color",
                  "has_reflective", "has_refractive", "ior", "emittance",
                  "dispersion")
_GEOM_KEYS = ("type", "material_id", "transform", "inverse_transform",
              "inverse_transpose", "velocity", "mesh_id")


def _tensor(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype))


def mesh_bundle_from_numpy(bundle: dict) -> T.MeshBundle:
    """A port `MeshBundle` from a dict of the JAX MeshBundle's fields."""
    ints = ("node_right", "node_start", "node_count", "node_skip",
            "mesh_root", "mesh_tri_offset")
    return T.MeshBundle(**{
        f.name: _tensor(bundle[f.name],
                        np.int32 if f.name in ints else np.float32)
        for f in dataclasses.fields(T.MeshBundle)})


def packed_mesh_from_numpy(packed: dict):
    """A port packed mesh from a dict of a JAX packed mesh's fields: the
    fused `nodes` table and `tris` of a PackedMesh8 (the 8-wide kernel
    reads nothing else), or `nodes_f`/`nodes_i`/`tris` of a binary
    PackedMesh (whose fused `nodes` rows are built from them)."""
    if packed.get("nodes") is not None:
        return PackedMesh8(nodes=_tensor(packed["nodes"], np.float32),
                           tris=_tensor(packed["tris"], np.float32))
    nodes_f = _tensor(packed["nodes_f"], np.float32)
    nodes_i = _tensor(packed["nodes_i"], np.int32)
    return PackedMesh(nodes_f=nodes_f, nodes_i=nodes_i,
                      tris=_tensor(packed["tris"], np.float32),
                      nodes=fuse_nodes(nodes_f, nodes_i))


def textures_from_numpy(textures: dict) -> T.Textures:
    """A port `Textures` from a dict of the JAX Textures' fields (every
    field the JAX dataclass has; a missing one takes the port's default).
    The uint32 planes become int32 tensors of the same bits, and env_prob
    stays float32, so every value carries over bit for bit."""
    out = {}
    for f in dataclasses.fields(T.Textures):
        a = textures.get(f.name)
        if a is None:
            continue
        a = np.array(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[f.name] = torch.from_numpy(a)
    return T.Textures(**out)


def scene_from_numpy(materials: dict, geoms: dict, camera: dict,
                     settings: Optional[T.RenderSettings] = None, *,
                     resolution: tuple,
                     meshes: Optional[T.MeshBundle] = None,
                     packed_meshes: tuple = (),
                     textures: Optional[dict] = None,
                     sdf_kinds: tuple = ()) -> T.Scene:
    """Build a port `Scene` from NumPy tables.

    `materials`/`geoms` map the JAX dataclass field names to arrays (a
    missing `dispersion` is zeros; `sdf_params` is carried when present and
    not None); `sdf_kinds` is the JAX Scene.sdf_kinds tuple; `camera` is the JAX `Camera.flat()` dict
    (position, view, up, right, pixel_length, aperture, focal_distance,
    shutter); `resolution` is (width, height), which `flat()` does not carry.
    `meshes` and `packed_meshes` are the port's (see the converters above);
    `textures` maps the JAX Textures' field names to arrays
    (`textures_from_numpy`; None = untextured).
    """
    n_mat = np.asarray(materials["color"]).shape[0]
    mats = {k: _tensor(materials[k], np.float32)
            for k in _MATERIAL_KEYS if materials.get(k) is not None}
    mats.setdefault("dispersion", torch.zeros((n_mat,), dtype=T.F32))
    ints = ("type", "material_id", "mesh_id")
    geom_t = {k: _tensor(geoms[k], np.int32 if k in ints else np.float32)
              for k in _GEOM_KEYS}
    if geoms.get("sdf_params") is not None:
        geom_t["sdf_params"] = _tensor(geoms["sdf_params"], np.float32)

    c = {k: np.asarray(v, np.float32) for k, v in camera.items()}
    w, h = resolution
    # fovy follows from pixel_length = 2 tan(fovy)/h (Camera.derive)
    fovy = float(np.degrees(np.arctan(c["pixel_length"][1] * h / 2.0)))
    cam = T.Camera(
        resolution=(int(w), int(h)), position=c["position"],
        look_at=c["position"] + c["view"], up=c["up"], view=c["view"],
        right=c["right"], pixel_length=c["pixel_length"], fovy=fovy,
        aperture=float(c["aperture"]),
        focal_distance=float(c["focal_distance"]),
        shutter=float(c["shutter"]))
    return T.Scene(camera=cam, settings=settings or T.RenderSettings(),
                   materials=T.Materials(**mats), geoms=T.Geoms(**geom_t),
                   meshes=meshes or T.MeshBundle.empty(),
                   packed_meshes=tuple(packed_meshes),
                   sdf_kinds=tuple(tuple(int(v) for v in k)
                                   for k in sdf_kinds),
                   textures=(None if textures is None
                             else textures_from_numpy(textures)))


def _param_tensors(params, device) -> RenderParams:
    """RenderParams of float32 tensors from an object with the JAX
    RenderParams' layout: `.materials` with the Materials fields, `.cam`
    the Camera.flat() dict."""
    mats = {k: getattr(params.materials, k, None) for k in _MATERIAL_KEYS}
    return RenderParams(
        materials=T.Materials(**{
            k: None if v is None else _tensor(v, np.float32).to(device)
            for k, v in mats.items()}),
        cam={k: _tensor(v, np.float32).to(device)
             for k, v in params.cam.items()})


def render_params_from_numpy(params, device) -> RenderParams:
    """The port's RenderParams (leaves that require grad) from the JAX
    RenderParams as NumPy, i.e. `jax.tree_util.tree_map(np.asarray,
    params)`."""
    out = _param_tensors(params, device)
    for t in param_leaves(out):
        t.requires_grad_(True)
    return out


def adam_state_from_numpy(state, device) -> AdamState:
    """The port's Adam state from optax's ScaleByAdamState as NumPy:
    `count`, and `mu`/`nu` laid out as the JAX RenderParams, whose leaves
    come out in `param_leaves` order."""
    return AdamState(
        count=torch.tensor(int(np.asarray(state.count)), dtype=torch.int32,
                           device=device),
        mu=param_leaves(_param_tensors(state.mu, device)),
        nu=param_leaves(_param_tensors(state.nu, device)))
