"""One scattering step of the wavefront without a gradient (S1).

`shade(hit, ray_d, throughput, alive, materials, textures, uniforms,
last_bounce, nee, nee_area)` is `ops/wavefront.shade_planar` for the
features the kernel csrc/shade.cu covers: the material colour, the
procedural checker, the constant env or the fused nearest atlas+env texel,
the emissive and miss radiance, area-light NEE (its direct term, the MIS
weight of an emissive hit and `nee_pdf`), the diffuse, mirror and Fresnel
refraction lobes. One thread a lane runs the whole step in registers and
writes each output plane once; under the fused texel a bounce is three
launches: the kernel's index entry point, P1 (`texfetch.take_u32`) on
those indices, and the shade entry point decoding the words.

`takes` is the route, read from the inputs themselves: CUDA tensors, none of
which takes a gradient while autograd records (the kernel has no
backward), every static gate the kernel does not implement off (the glossy
lobe, the sky, bump and normal maps, bilinear fetches, dispersion, env and
mixed NEE), and a texture layout it implements (no atlas or env map, or the
fused nearest table). Everything else (the CPU, the train step's autograd,
the other features) stays on `shade_planar`'s torch chain, which the kernel
repeats bit for bit on the card. Inputs the route admits but the kernel
cannot read (a plane of another dtype or shape, a table on another
device, a `last_bounce` plane) raise in `shade`.

The kernel library is built at the first call on a card. Each shade launch
counts under `shade`, each index launch under `shade_index`, and from the
device each adds one to its slot of utils/launches.py's tally.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from ..scene import types as T
from ..utils import cuda_build
from ..utils.launches import count, tally_address
from . import texfetch
from .vec import V3

# csrc/shade.cu's input planes, in order: float32, then the int64 material,
# the u8 flags and the int32 texel word
IN_PLANES = ("t", "nx", "ny", "nz", "px", "py", "pz", "sx", "sy", "sz", "u",
             "v", "dx", "dy", "dz", "thx", "thy", "thz", "u_lobe", "u1", "u2",
             "u_fresnel", "wlx", "wly", "wlz", "lex", "ley", "lez", "pdf_l",
             "prev_pdf", "mat_id", "outside", "alive", "vis", "texel")
FLOAT_PLANES = IN_PLANES.index("mat_id")
# the planes the index entry point reads
INDEX_PLANES = ("t", "u", "v", "dx", "dy", "dz", "mat_id")
# its output planes (float32), then `alive` (u8)
OUT_PLANES = ("ox", "oy", "oz", "dx", "dy", "dz", "thx", "thy", "thz", "rx",
              "ry", "rz", "nee_pdf")
# its material tables and their dtypes
TABLES = ("color", "specular_color", "emittance", "has_refractive",
          "has_reflective", "ior", "checker_scale", "checker_color2", "rect",
          "tex_id")
TABLE_DTYPES = (torch.float32,) * 8 + (torch.int32,) * 2
# the kernel's device: `takes` leaves tensors elsewhere to the chain
DEVICE = "cuda"


def _dtype(name: str) -> torch.dtype:
    """The dtype of the input plane `name`."""
    if IN_PLANES.index(name) < FLOAT_PLANES:
        return torch.float32
    return {"mat_id": torch.int64, "texel": torch.int32}.get(name,
                                                              torch.bool)


def _tables(materials: T.Materials, textures: T.Textures) -> list:
    return [getattr(materials, k) if hasattr(materials, k)
            else getattr(textures, k) for k in TABLES]


def layout(textures: T.Textures) -> Optional[bool]:
    """The texture layout as the kernel takes it: False, no atlas or env map
    (the constant env); True, the fused nearest atlas+env table; None, one
    it does not implement."""
    if not textures.has_atlas and not textures.has_env:
        return False
    na = textures.atlas.shape[0] * textures.atlas.shape[1]
    ne = textures.env.shape[0] * textures.env.shape[1]
    if (textures.has_atlas and textures.has_env
            and texfetch.full(textures.atlas_packed, na)
            and texfetch.full(textures.env_packed, ne)
            and texfetch.full(textures.fused_packed, na + ne)):
        return True
    return None


def _inputs(hit, ray_d: V3, throughput=None, alive=None, uniforms=(),
            nee: Optional[tuple] = None,
            texel: Optional[torch.Tensor] = None) -> dict:
    """The input planes given, by their IN_PLANES names: the hit record and
    the ray's direction, then those of the other arguments given."""
    planes = dict(zip(IN_PLANES, (hit.t, *hit.normal, *hit.point,
                                  *hit.surf, hit.u, hit.v, *ray_d)),
                  mat_id=hit.mat_id, outside=hit.outside)
    if throughput is not None:
        planes.update(zip(IN_PLANES[IN_PLANES.index("thx"):],
                          (*throughput, *uniforms)))
        planes["alive"] = alive
    if nee is not None:
        planes.update(zip(IN_PLANES[IN_PLANES.index("wlx"):],
                          (*nee[0], *nee[2], nee[3], nee[4])))
        planes["vis"] = nee[1]
    if texel is not None:
        planes["texel"] = texel
    return planes


def takes(hit, ray_d: V3, throughput: V3, alive: torch.Tensor,
          materials: T.Materials, textures: T.Textures,
          uniforms: Sequence[torch.Tensor], nee: Optional[tuple],
          glossy: bool, nee_area: float, sky: bool, nee_env_c: float,
          nee_q: float, bump: bool, nmap: bool, bilinear: bool,
          dispersion: bool) -> bool:
    """Whether the kernel runs this shading step: the hit record on a CUDA
    device, no input taking a gradient while autograd records, the gates
    it does not implement off (`bilinear_fast` acts only with
    `bilinear`), NEE absent or area lights alone (`nee_area` > 0,
    `nee_env_c` 0, `nee_q` 1) and a layout it implements. The inputs'
    dtypes, shapes and devices are `shade`'s to check."""
    if hit.t.device.type != DEVICE:
        return False
    if glossy or sky or bump or nmap or bilinear or dispersion:
        return False
    if nee is not None and not (nee_area > 0.0 and nee_env_c == 0.0
                                and nee_q == 1.0):
        return False
    if layout(textures) is None:
        return False
    if not torch.is_grad_enabled():
        return True
    ins = [*_inputs(hit, ray_d, throughput, alive, uniforms, nee).values(),
           *_tables(materials, textures), textures.env, textures.env_enabled]
    return not any(t.requires_grad for t in ins)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load("shade")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.shade_launch.restype = i32
    lib.shade_launch.argtypes = [
        i32, i32, i64, ctypes.POINTER(ptr), ctypes.POINTER(i64),
        ctypes.POINTER(ptr), i32, ptr, ptr, ctypes.c_float, i32,
        ctypes.POINTER(ptr), ptr, ptr, ptr]
    lib.shade_index_launch.restype = i32
    lib.shade_index_launch.argtypes = [
        i64, ctypes.POINTER(ptr), ctypes.POINTER(i64), ctypes.POINTER(ptr),
        i32, i32, i32, i32, i32, ptr, ptr, ptr]
    lib.shade_planes.restype = i32
    lib.shade_planes.argtypes = []
    lib.shade_error_string.restype = ctypes.c_char_p
    lib.shade_error_string.argtypes = [i32]
    if lib.shade_planes() != len(IN_PLANES):
        raise RuntimeError("csrc/shade.cu's PLANES is not "
                           f"ops/shade.IN_PLANES ({len(IN_PLANES)})")
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"shade {what} failed: "
                           + _kernel_lib().shade_error_string(rc).decode())


def _checked(planes: dict, n: int, dev) -> dict:
    """`planes` detached, booleans as u8 views; raises ValueError unless
    each is an [n] plane of its dtype on `dev`."""
    for name, t in planes.items():
        dtype = _dtype(name)
        if t.dtype != dtype or t.device != dev or t.shape != (n,):
            raise ValueError(f"{name} must be a {dtype} [{n}] plane on {dev}"
                             f", not {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    return {k: t.detach().view(torch.uint8) if t.dtype == torch.bool
            else t.detach() for k, t in planes.items()}


def _pointers(planes: dict):
    ptrs = (ctypes.c_void_p * len(IN_PLANES))(
        *[planes[k].data_ptr() if k in planes else None for k in IN_PLANES])
    strides = (ctypes.c_longlong * len(IN_PLANES))(
        *[planes[k].stride(0) if k in planes else 0 for k in IN_PLANES])
    return ptrs, strides


def _table_pointers(materials: T.Materials, textures: T.Textures, dev):
    """TABLES made contiguous (a no-op for the renderer's), kept alive by
    the caller, and their pointers; raises ValueError unless they are of
    TABLE_DTYPES with a row a material, and `env` and `env_enabled`
    float32, all on `dev`."""
    m = materials.color.shape[0]
    for name, t, dtype in zip(TABLES, _tables(materials, textures),
                              TABLE_DTYPES):
        if t.dtype != dtype or t.device != dev or t.shape[0] < m:
            raise ValueError(f"the {name} table must be {dtype} on {dev} "
                             f"with {m} rows, not {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name in ("env", "env_enabled"):
        t = getattr(textures, name)
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name} must be float32 on {dev}")
    tabs = [t.detach().contiguous() for t in _tables(materials, textures)]
    return tabs, (ctypes.c_void_p * len(TABLES))(
        *[t.data_ptr() for t in tabs])


def index_planes(hit, ray_d: V3) -> dict:
    """INDEX_PLANES by name, checked as `_checked` does."""
    planes = _inputs(hit, ray_d)
    return _checked({k: planes[k] for k in INDEX_PLANES}, hit.t.shape[0],
                    hit.t.device)


def shade_planes(hit, ray_d: V3, throughput: V3, alive: torch.Tensor,
                 uniforms: Sequence[torch.Tensor], nee: Optional[tuple],
                 texel: Optional[torch.Tensor]) -> dict:
    """The IN_PLANES the shade entry point reads, by name, checked as
    `_checked` does: the NEE planes under `nee`, `texel` where given."""
    if len(uniforms) != 4:
        raise ValueError(f"four uniform planes, not {len(uniforms)}")
    return _checked(_inputs(hit, ray_d, throughput, alive, uniforms, nee,
                            texel), hit.t.shape[0], hit.t.device)


def fused_index(hit, ray_d: V3, materials: T.Materials,
                textures: T.Textures) -> torch.Tensor:
    """[N] int32: each lane's index into the fused atlas+env table, the
    kernel's index entry point (`_atlas_flat_index` on hit lanes, Ha*Wa +
    `_env_flat_index` on miss lanes)."""
    n, dev = hit.t.shape[0], hit.t.device
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    planes = index_planes(hit, ray_d)
    tabs, mats = _table_pointers(materials, textures, dev)
    ptrs, strides = _pointers(planes)
    ha, wa = textures.atlas.shape[0], textures.atlas.shape[1]
    he, we = textures.env.shape[0], textures.env.shape[1]
    with torch.cuda.device(dev):
        rc = _kernel_lib().shade_index_launch(
            n, ptrs, strides, mats, materials.color.shape[0], ha, wa, he, we,
            out.data_ptr(), tally_address(dev, "shade_index"),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "index launch")
    count("shade_index")
    return out


def shade(hit, ray_d: V3, throughput: V3, alive: torch.Tensor,
          materials: T.Materials, textures: T.Textures,
          uniforms: Sequence[torch.Tensor], last_bounce: bool,
          nee: Optional[tuple] = None, nee_area: float = 0.0,
          texel: Optional[torch.Tensor] = None):
    """csrc/shade.cu on the current stream (checks, outputs by torch.empty,
    no sync) for inputs `takes` admits: `shade_planar`'s ShadeOutP, with
    `nee_pdf` under `nee`. `last_bounce` is a Python bool. Under the fused
    layout the texel words are `texel` where given, else fetched here
    (`fused_index`, then P1). Raises ValueError on an input the kernel
    cannot read, TypeError on a `last_bounce` plane."""
    from .wavefront import ShadeOutP
    if torch.is_tensor(last_bounce):
        raise TypeError("the kernel takes `last_bounce` as a Python bool; "
                        "an [N] plane is the chain's (`shade_plain`)")
    n, dev = hit.t.shape[0], hit.t.device
    fused = layout(textures)
    if fused is None:
        raise ValueError("a texture layout the kernel does not implement")
    if not fused:
        texel = None
    elif texel is None:
        texel = texfetch.take_u32(textures.fused_packed,
                                  fused_index(hit, ray_d, materials,
                                              textures))
    outs = [torch.empty((n,), dtype=torch.float32, device=dev)
            for _ in OUT_PLANES[:-1]]
    outs.append(torch.empty((n,), dtype=torch.float32, device=dev)
                if nee is not None else None)
    out_alive = torch.empty((n,), dtype=torch.bool, device=dev)
    if n > 0:
        planes = shade_planes(hit, ray_d, throughput, alive, uniforms, nee,
                              texel)
        tabs, mats = _table_pointers(materials, textures, dev)
        ptrs, strides = _pointers(planes)
        scale = textures.env_enabled.detach()
        env = textures.env[0, 0].detach().contiguous()
        out_ptrs = (ctypes.c_void_p * len(OUT_PLANES))(
            *[None if t is None else t.data_ptr() for t in outs])
        with torch.cuda.device(dev):
            rc = _kernel_lib().shade_launch(
                int(nee is not None), int(bool(fused)), n, ptrs, strides,
                mats, materials.color.shape[0], env.data_ptr(),
                scale.data_ptr(), float(nee_area),
                int(bool(last_bounce)),
                out_ptrs, out_alive.data_ptr(), tally_address(dev, "shade"),
                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "launch")
        count("shade")
    return ShadeOutP(origin=V3(*outs[0:3]), direction=V3(*outs[3:6]),
                     throughput=V3(*outs[6:9]), radiance=V3(*outs[9:12]),
                     alive=out_alive, nee_pdf=outs[12])
