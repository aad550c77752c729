"""Scene data model: host camera/settings + structure-of-arrays tensor tables.

Counterpart of project3_cuda_path_tracer_tpu/scene/types.py. Tables are
torch tensors with the JAX package's shapes ([M,3], [G,4,4], ...), built on
the CPU by the parser; a renderer moves what it needs to its own device
(ops/megakernel.pack_scene).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..utils import math as m

# GeomType (reference: src/sceneStructs.h:10-13)
SPHERE = 0
CUBE = 1
MESH = 2
SDF = 3

F32 = torch.float32
I32 = torch.int32


@dataclass
class Materials:
    """SoA material table (reference: src/sceneStructs.h:31-41); leading dim M."""
    color: torch.Tensor              # [M,3]
    specular_exponent: torch.Tensor  # [M]
    specular_color: torch.Tensor     # [M,3]
    has_reflective: torch.Tensor     # [M] specular lobe probability
    has_refractive: torch.Tensor     # [M] refractive lobe probability
    ior: torch.Tensor                # [M]
    emittance: torch.Tensor          # [M]
    dispersion: Optional[torch.Tensor] = None  # [M]


@dataclass
class Geoms:
    """SoA geometry table (reference: src/sceneStructs.h:20-29). Canonical
    primitives are the r=0.5 sphere and the [-0.5,0.5]^3 cube in object
    space; `velocity` is the motion-blur translation per unit shutter time."""
    type: torch.Tensor               # [G] int32
    material_id: torch.Tensor        # [G] int32
    transform: torch.Tensor          # [G,4,4]
    inverse_transform: torch.Tensor  # [G,4,4]
    inverse_transpose: torch.Tensor  # [G,4,4]
    velocity: torch.Tensor           # [G,3]
    mesh_id: torch.Tensor            # [G] int32; -1 for primitives
    # [G, ops.sdf.PARAM_SLOTS] float32 SDF shape parameters, zeros on the
    # other geoms; None when the scene has no SDF geom
    sdf_params: Optional[torch.Tensor] = None


@dataclass
class MeshBundle:
    """Flattened triangle-mesh + BVH arrays shared by all MESH geoms (the
    JAX MeshBundle, field for field).

    All meshes are concatenated; per-geom `mesh_id` selects a (node, tri)
    range. Built on the host (scene/bvh.py); the traversal kernels read the
    per-mesh packed forms (ops/bvh8.pack_all8, ops/pallas_bvh.pack_all).
    """
    # triangle soup, object space
    tri_v0: torch.Tensor     # [T,3]
    tri_e1: torch.Tensor     # [T,3]  v1 - v0
    tri_e2: torch.Tensor     # [T,3]  v2 - v0
    tri_n0: torch.Tensor     # [T,3]  vertex normals (face normal if absent)
    tri_n1: torch.Tensor     # [T,3]
    tri_n2: torch.Tensor     # [T,3]
    tri_uv0: torch.Tensor    # [T,2]
    tri_uv1: torch.Tensor    # [T,2]
    tri_uv2: torch.Tensor    # [T,2]
    # flattened BVH (depth-first skip-pointer layout)
    node_lo: torch.Tensor     # [B,3]  aabb min
    node_hi: torch.Tensor     # [B,3]  aabb max
    node_right: torch.Tensor  # [B] int32: right-child index (internal) or -1
    node_start: torch.Tensor  # [B] int32: first tri (leaf) else -1
    node_count: torch.Tensor  # [B] int32: tri count (leaf) else 0
    node_skip: torch.Tensor   # [B] int32: next node if subtree skipped
    mesh_root: torch.Tensor   # [K] int32: BVH root node per mesh
    mesh_tri_offset: torch.Tensor  # [K] int32

    @staticmethod
    def empty() -> "MeshBundle":
        f3 = torch.zeros((1, 3), dtype=F32)
        f2 = torch.zeros((1, 2), dtype=F32)
        i1 = torch.zeros((1,), dtype=I32)
        return MeshBundle(
            tri_v0=f3, tri_e1=f3, tri_e2=f3,
            tri_n0=f3, tri_n1=f3, tri_n2=f3,
            tri_uv0=f2, tri_uv1=f2, tri_uv2=f2,
            node_lo=f3, node_hi=f3,
            node_right=i1 - 1, node_start=i1, node_count=i1,
            node_skip=i1 - 1, mesh_root=i1, mesh_tri_offset=i1)


@dataclass
class Textures:
    """Texture atlas, environment and per-material texture tables (the JAX
    Textures, field for field; BASELINE config 5).

    One [Ha,Wa,3] atlas holds every image of the scene as a vertical strip;
    material m reads its rectangle rect[m] = (x, y, w, h) when tex_id[m] >=
    0, and its normal map's nrm_rect[m] when nrm_id[m] >= 0. `env` is an
    equirect [He,We,3] radiance image gated by env_enabled. checker_scale[m]
    > 0 blends the material colour with checker_color2[m] on a uv
    checkerboard; bump[m] = (scale, freq) is the procedural bump; sky [14]
    = enabled, zenith rgb, horizon rgb, sun dir xyz, sun rgb, sun sharpness.

    The packed planes carry 32-bit texels, stored as int32 bit patterns
    (the JAX package's uint32 values, bit for bit), and are fetched by one
    gather each (ops/texfetch.py): atlas_packed R8G8B8, env_packed Radiance
    RGBE, atlas_pair RGB565 horizontal pairs and env_pair 12-bit
    shared-exponent pairs (--bilinear-fast), env_alias/env_prob the env
    map's alias table (env-map NEE). A plane of shape (1,) is absent.
    `fused_packed` and `fused_pair` are the port's own: the atlas plane and
    the env plane concatenated (the env's texels from index Ha*Wa), which
    `ops.texfetch.fuse` builds once for a scene that has both, so that a
    bounce fetches hit and miss lanes with one gather.

    The fields after `nrm_id` may be left out: they default to the absent
    or zero form for tex_id's material count."""
    atlas: torch.Tensor         # [Ha,Wa,3] float32
    tex_id: torch.Tensor        # [M] int32, -1 = untextured
    env: torch.Tensor           # [He,We,3] float32
    env_enabled: torch.Tensor   # [] float32 (0/1)
    sky: torch.Tensor           # [14] float32; sky[0] > 0 enables it
    bump: torch.Tensor          # [M,2] float32 (scale, freq)
    nrm_id: torch.Tensor        # [M] int32, -1 = none
    rect: Optional[torch.Tensor] = None            # [M,4] int32
    checker_scale: Optional[torch.Tensor] = None   # [M] float32, 0 = off
    checker_color2: Optional[torch.Tensor] = None  # [M,3] float32
    nrm_rect: Optional[torch.Tensor] = None        # [M,4] int32
    atlas_packed: Optional[torch.Tensor] = None    # [Ha*Wa] int32 bits
    env_packed: Optional[torch.Tensor] = None      # [He*We] int32 bits
    atlas_pair: Optional[torch.Tensor] = None      # [Ha*Wa] int32 bits
    env_pair: Optional[torch.Tensor] = None        # [He*We] int32 bits
    env_alias: Optional[torch.Tensor] = None       # [He*We] int32
    env_prob: Optional[torch.Tensor] = None        # [He*We] float32
    fused_packed: Optional[torch.Tensor] = None    # [Ha*Wa + He*We] bits
    fused_pair: Optional[torch.Tensor] = None      # [Ha*Wa + He*We] bits

    def __post_init__(self):
        m = int(self.tex_id.shape[0])
        defaults = dict(
            rect=lambda: torch.zeros((m, 4), dtype=I32),
            checker_scale=lambda: torch.zeros((m,), dtype=F32),
            checker_color2=lambda: torch.zeros((m, 3), dtype=F32),
            nrm_rect=lambda: torch.zeros((m, 4), dtype=I32),
            env_prob=lambda: torch.zeros((1,), dtype=F32))
        for name in ("atlas_packed", "env_packed", "atlas_pair", "env_pair",
                     "env_alias", "fused_packed", "fused_pair"):
            defaults[name] = lambda: torch.zeros((1,), dtype=I32)
        for name, make in defaults.items():
            if getattr(self, name) is None:
                setattr(self, name, make())

    @property
    def has_atlas(self) -> bool:
        return self.atlas.shape[0] > 1 or self.atlas.shape[1] > 1

    @property
    def has_env(self) -> bool:
        return self.env.shape[0] > 1 or self.env.shape[1] > 1

    @staticmethod
    def none(num_materials: int) -> "Textures":
        n = max(num_materials, 1)
        return Textures(
            atlas=torch.zeros((1, 1, 3), dtype=F32),
            tex_id=-torch.ones((n,), dtype=I32),
            env=torch.zeros((1, 1, 3), dtype=F32),
            env_enabled=torch.zeros((), dtype=F32),
            sky=torch.zeros((14,), dtype=F32),
            bump=torch.zeros((n, 2), dtype=F32),
            nrm_id=-torch.ones((n,), dtype=I32),
        )


@dataclass
class Camera:
    """Host-side camera (reference: src/sceneStructs.h:43-52); NumPy fields.

    Derived quantities follow Scene::loadCamera (src/scene.cpp:132-142):
      yscaled = tan(fovy deg); xscaled = yscaled * resx / resy
      pixel_length = (2*xscaled/resx, 2*yscaled/resy)
      view = normalize(lookAt - position)
    Extensions: thin-lens DoF (aperture, focal_distance) and shutter time."""
    resolution: tuple  # (w, h)
    position: np.ndarray
    look_at: np.ndarray
    up: np.ndarray
    view: np.ndarray = None
    right: np.ndarray = None
    fov: np.ndarray = None
    pixel_length: np.ndarray = None
    fovy: float = 45.0
    aperture: float = 0.0
    focal_distance: float = 0.0
    shutter: float = 0.0

    def derive(self) -> "Camera":
        w, h = self.resolution
        yscaled = np.tan(self.fovy * (m.PI / 180.0))
        xscaled = yscaled * w / h
        fovx = np.arctan(xscaled) * 180.0 / m.PI
        self.fov = np.array([fovx, self.fovy], dtype=np.float32)
        self.pixel_length = np.array(
            [2.0 * xscaled / w, 2.0 * yscaled / h], dtype=np.float32)
        self.view = m.normalize(np.asarray(self.look_at) - np.asarray(self.position))
        r = np.cross(self.view, np.asarray(self.up, dtype=np.float32))
        self.right = m.normalize(r)
        self.up = m.normalize(np.cross(self.right, self.view))
        self.position = np.asarray(self.position, dtype=np.float32)
        self.look_at = np.asarray(self.look_at, dtype=np.float32)
        return self

    def flat(self, device: torch.device | str = "cpu") -> dict:
        """Dict of float32 tensors on `device` (the JAX `flat()` pytree)."""
        def t(v):
            return torch.tensor(np.asarray(v, np.float32), device=device)
        return dict(
            position=t(self.position), view=t(self.view), up=t(self.up),
            right=t(self.right), pixel_length=t(self.pixel_length),
            aperture=t(self.aperture), focal_distance=t(self.focal_distance),
            shutter=t(self.shutter))


@dataclass
class RenderSettings:
    """The render settings the port reads (reference:
    src/sceneStructs.h:54-60, plus the JAX package's extensions)."""
    iterations: int = 5000
    trace_depth: int = 8
    image_name: str = "render"
    antialias: bool = True
    # Per-pixel Cranley-Patterson-rotated lattice draws keyed on (iteration,
    # depth, pixel) instead of the pseudo-random stream (ops/wavefront).
    stratified: bool = False
    seed: int = 0
    # Direct lighting (ops/nee.py, render/integrator._wire_nee): one light
    # sample a bounce with one-sample MIS, from the area lights, the env
    # map, or a mixture of both; RIS over `nee_ris` candidates (>= 2);
    # temporal ReSTIR over `restir` fresh candidates a frame (area lights
    # only), its reservoir count capped at restir_cap * restir.
    nee: bool = False
    nee_ris: int = 0
    restir: int = 0
    restir_cap: float = 20.0
    # Bilinear texture and env filtering (--bilinear: four corner fetches);
    # with bilinear_fast (--bilinear-fast) two fetches of the horizontal
    # pair planes, built at first use (render/integrator.build_trace_config)
    bilinear: bool = False
    bilinear_fast: bool = False
    # The integrator features of slice E (render/integrator.py): material
    # sort and compaction of the wavefront each bounce (--sort, --compact;
    # the image is unchanged bit for bit), Russian roulette from the third
    # bounce (--russian-roulette), the stratified sampler's implementation
    # ("lattice" or "sobol", --sampler), the per-sample radiance clamp (0 =
    # off, --clamp), and the cache of the depth-0 hits, valid without AA,
    # depth of field and motion blur.
    sort_materials: bool = False
    compact: bool = False
    russian_roulette: bool = False
    strat_impl: str = "lattice"
    clamp: float = 0.0
    first_bounce_cache: bool = False
    # Adaptive sampling (render/adaptive.py, --adaptive): the path budget
    # is re-allocated to high-variance pixels every `adaptive_epoch`
    # iterations (--adaptive-epoch); the first epoch is a uniform warm-up.
    adaptive: bool = False
    adaptive_epoch: int = 32


@dataclass
class Scene:
    """Parsed scene: host camera/settings + CPU tensor tables."""
    camera: Camera
    settings: RenderSettings
    materials: Materials
    geoms: Geoms
    meshes: MeshBundle = field(default_factory=MeshBundle.empty)
    textures: Optional[Textures] = None
    source_path: str = ""
    # One packed traversal table per mesh of `meshes`: ops/bvh8.PackedMesh8
    # (the parser's default, kernel K2) or ops/pallas_bvh.PackedMesh (the
    # binary tree, kernels K3/K4). The integrator dispatches on the type.
    packed_meshes: tuple = ()
    # Per-geom SDF kind triples (kind, aux_a, aux_b) of ops/sdf.py,
    # (-1, -1, -1) for the other geoms; () when the scene has no SDF geom.
    sdf_kinds: tuple = ()

    def __post_init__(self):
        if self.textures is None:
            self.textures = Textures.none(int(self.materials.color.shape[0]))

    @property
    def num_geoms(self) -> int:
        return int(self.geoms.type.shape[0])

    @property
    def num_materials(self) -> int:
        return int(self.materials.color.shape[0])
