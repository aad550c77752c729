// One whole progressive path-tracing iteration in one CUDA kernel (sm_90a).
//
// Replaces the Pallas TPU kernel project3_cuda_path_tracer_tpu/ops/
// megakernel.py::_make_kernel: ray generation (AA jitter, thin lens, shutter
// time), then per bounce the nearest hit over <= 32 cubes/spheres with
// velocity shift, emission and miss, the diffuse / mirror / Fresnel lobe and
// the throughput update, and finally accum += radiance. Its arithmetic is
// that of the port's plain version (ops/wavefront.py, chained by
// render/integrator.trace_wavefront), which it is held against; where the
// Pallas kernel differs from the JAX wavefront (the transmitted-ray origin,
// the normalisation floor, the zero-component slab guard) this kernel
// follows the wavefront.
//
// What bounds it: arithmetic and divergence, not memory. At 800x800 and
// depth 8 it runs 640k threads x up to 8 bounces x 7 primitive tests, each
// test ~60-90 flops, while each thread touches only its 12 accumulator bytes
// (read and written once) and, per bounce, the injected uniforms when a test
// feeds them. Paths end at different bounces and take different lobes, so
// warps diverge.
//
// What the design does about it: one thread per ray keeps the whole path in
// registers for all bounces (no per-bounce state in device memory); a path
// that dies leaves the bounce loop at once, so dead lanes cost no tests; the
// scene (transforms, materials, camera: under 8 KB for 32 geoms) is a
// runtime table that each block copies to shared memory, where every thread
// of a warp reads the same word (a broadcast), so one build serves every
// scene and camera; each thread owns its pixel's accumulator, so there are
// no atomics and a fixed seed gives a bitwise-repeatable image.
//
// Random numbers, chosen by `sampler`:
//   0 Philox4x32-10, key (seed, 0), counter (pixel, iteration, bounce, draw);
//     bounce 0xFFFFFFFF holds the camera draws;
//   1 the stratified lattice of ops/wavefront.stratified_planes, bit for bit
//     (the lattice sum is rounded op by op, as in torch);
//   2 injected uniforms: cam_u [5,N] and u [depth,4,N], row-major planes.
//
// C interface (bound with ctypes by ops/megakernel.py): megakernel_iteration
// launches on `stream` without synchronising and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// table layout: ops/megakernel.py
constexpr int HEADER = 20;
constexpr int GEOM_STRIDE = 40;
constexpr int MAT_STRIDE = 16;
constexpr int CUBE = 1;

constexpr int SAMPLER_PHILOX = 0;
constexpr int SAMPLER_STRATIFIED = 1;
constexpr int SAMPLER_UNIFORMS = 2;

constexpr float BIG = 1e30f;
constexpr float RAY_EPS = 1e-4f;
constexpr float TWO_PI = 6.2831853071795864769252867665590057683943f;
constexpr float SQRT_OF_ONE_THIRD = 0.5773502691896257645091487805019574556476f;

constexpr unsigned CAMERA_SLOT = 0x7FFFFFFFu;
constexpr unsigned SALT_AA = 0x68BC21EBu;
constexpr unsigned SALT_LENS = 0x51633E2Du;
constexpr unsigned SALT_TIME = 0x3504F333u;
constexpr unsigned SALT_BOUNCE = 0x2545F491u;
constexpr float R2A0 = 0.7548776662466927f, R2A1 = 0.5698402909980532f;
constexpr float R4A0 = 0.8566748838545029f, R4A1 = 0.7338918566271259f;
constexpr float R4A2 = 0.6287067210378086f, R4A3 = 0.5385972572236101f;
constexpr float PHI_INV = 0.6180339887498949f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
// Double-where floor of ops/vec.normalize: near-zero vectors pass unscaled.
__device__ __forceinline__ V3 normalize(V3 a) {
  float d2 = dot(a, a);
  float s = rsqrtf(d2 > 1e-12f ? d2 : 1.0f);
  return v3(a.x * s, a.y * s, a.z * s);
}
// Rows of a row-major 3x4 affine block / 3x3 block.
__device__ __forceinline__ V3 xform_pt(const float* m, V3 p) {
  return v3(m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
            m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
            m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]);
}
__device__ __forceinline__ V3 xform_dir34(const float* m, V3 v) {
  return v3(m[0] * v.x + m[1] * v.y + m[2] * v.z,
            m[4] * v.x + m[5] * v.y + m[6] * v.z,
            m[8] * v.x + m[9] * v.y + m[10] * v.z);
}
__device__ __forceinline__ V3 xform_dir33(const float* m, V3 v) {
  return v3(m[0] * v.x + m[1] * v.y + m[2] * v.z,
            m[3] * v.x + m[4] * v.y + m[5] * v.z,
            m[6] * v.x + m[7] * v.y + m[8] * v.z);
}

// ---- random numbers -------------------------------------------------------

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}
// top 24 bits -> [0, 1)
__device__ __forceinline__ float u01(unsigned x) {
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// ops/wavefront._hash01 in native uint32
__device__ __forceinline__ float hash01(unsigned x, unsigned salt) {
  x ^= salt;
  x = (x ^ (x >> 16)) * 0x45D9F3Bu;
  x = (x ^ (x >> 16)) * 0x45D9F3Bu;
  x = x ^ (x >> 16);
  return (float)(x & 0x00FFFFFFu) * (1.0f / 16777216.0f);
}
// One stratified_planes dimension: fmod(0.5 + it*alpha + hash, 1), rounded
// op by op (no FMA contraction) so it equals the torch version bitwise.
__device__ __forceinline__ float lattice(float it_f, float alpha,
                                         unsigned mix, unsigned salt) {
  float v = __fadd_rn(__fadd_rn(0.5f, __fmul_rn(it_f, alpha)),
                      hash01(mix, salt));
  return fmodf(v, 1.0f);
}

// ---- one primitive --------------------------------------------------------

__device__ __forceinline__ float nz(float c) {
  return fabsf(c) < 1e-12f ? (c < 0.0f ? -1e-12f : 1e-12f) : c;
}

struct Hit {
  float t;  // world distance to the backed-off point; BIG = none yet
  V3 normal, point, surf;
  int mat;
  bool outside;
};

// ops/wavefront._primitive_hit_planar, merged into `best` with a strict <.
__device__ __forceinline__ void hit_geom(const float* gp, V3 o, V3 d, float tm,
                                         Hit& best) {
  const float* inv = gp;
  const float* fwd = gp + 12;
  const float* ivt = gp + 24;
  V3 vel = v3(gp[33], gp[34], gp[35]);
  bool cube = (int)gp[36] == CUBE;

  V3 osh = v3(o.x - vel.x * tm, o.y - vel.y * tm, o.z - vel.z * tm);
  V3 qo = xform_pt(inv, osh);
  V3 qd = normalize(xform_dir34(inv, d));

  float t_obj;
  bool hit, outside;
  V3 nl;
  if (cube) {  // slab test, src/intersections.h:48-90
    float ix = 1.0f / nz(qd.x), iy = 1.0f / nz(qd.y), iz = 1.0f / nz(qd.z);
    float t1x = (-0.5f - qo.x) * ix, t2x = (0.5f - qo.x) * ix;
    float t1y = (-0.5f - qo.y) * iy, t2y = (0.5f - qo.y) * iy;
    float t1z = (-0.5f - qo.z) * iz, t2z = (0.5f - qo.z) * iz;
    float tax = fminf(t1x, t2x), tbx = fmaxf(t1x, t2x);
    float tay = fminf(t1y, t2y), tby = fmaxf(t1y, t2y);
    float taz = fminf(t1z, t2z), tbz = fmaxf(t1z, t2z);
    float tpx = tax > 0.0f ? tax : -BIG;
    float tpy = tay > 0.0f ? tay : -BIG;
    float tpz = taz > 0.0f ? taz : -BIG;
    float tmin = fmaxf(tpx, fmaxf(tpy, tpz));
    float tmax = fminf(tbx, fminf(tby, tbz));
    hit = (tmax >= tmin) && (tmax > 0.0f);
    outside = tmin > 0.0f;
    t_obj = outside ? tmin : tmax;
    bool ex = outside ? (tpx == tmin) : (tbx == tmax);
    bool ey = !ex && (outside ? (tpy == tmin) : (tby == tmax));
    bool ez = !(ex || ey);
    nl = v3(ex ? (t2x < t1x ? 1.0f : -1.0f) : 0.0f,
            ey ? (t2y < t1y ? 1.0f : -1.0f) : 0.0f,
            ez ? (t2z < t1z ? 1.0f : -1.0f) : 0.0f);
  } else {  // r = 0.5 sphere, src/intersections.h:102-144
    float vdd = dot(qo, qd);
    float radicand = vdd * vdd - (dot(qo, qo) - 0.25f);
    bool has_root = radicand >= 0.0f;
    float s = sqrtf(has_root ? fmaxf(radicand, 0.0f) : 1.0f);
    float t1 = -vdd + s, t2 = -vdd - s;
    bool both_neg = (t1 < 0.0f) && (t2 < 0.0f);
    bool both_pos = (t1 > 0.0f) && (t2 > 0.0f);
    t_obj = both_pos ? fminf(t1, t2) : fmaxf(t1, t2);
    hit = has_root && !both_neg;
    outside = both_pos;
  }
  if (!hit) return;

  // Hit points as fused multiply-adds (ops/wavefront._fma): in object space
  // t*dir reaches ~1e3 on thin slabs, where a separately rounded product
  // would eat the 1e-4 back-off.
  float tb = t_obj - RAY_EPS;
  V3 ip = v3(fmaf(tb, qd.x, qo.x), fmaf(tb, qd.y, qo.y), fmaf(tb, qd.z, qo.z));
  V3 ipw = xform_pt(fwd, ip);
  ipw = v3(ipw.x + vel.x * tm, ipw.y + vel.y * tm, ipw.z + vel.z * tm);
  V3 dw = v3(o.x - ipw.x, o.y - ipw.y, o.z - ipw.z);
  float t_world = sqrtf(dot(dw, dw));
  if (!(t_world < best.t)) return;

  V3 sf = v3(fmaf(t_obj, qd.x, qo.x), fmaf(t_obj, qd.y, qo.y),
            fmaf(t_obj, qd.z, qo.z));
  V3 sfw = xform_pt(fwd, sf);
  sfw = v3(sfw.x + vel.x * tm, sfw.y + vel.y * tm, sfw.z + vel.z * tm);
  if (!cube) {
    float flip = outside ? 1.0f : -1.0f;
    nl = v3(ip.x * flip, ip.y * flip, ip.z * flip);
  }
  best.t = t_world;
  best.normal = normalize(xform_dir33(ivt, nl));
  best.point = ipw;
  best.surf = sfw;
  best.mat = (int)gp[37];
  best.outside = outside;
}

// ---- the kernel -----------------------------------------------------------

__global__ void __launch_bounds__(128)
megakernel(float* __restrict__ accum, const float* __restrict__ table,
           int table_len, int width, int height, int depth, int antialias,
           int dof, int motion, int sampler, unsigned iteration,
           unsigned seed, const float* __restrict__ cam_u,
           const float* __restrict__ u) {
  extern __shared__ float s[];
  for (int k = threadIdx.x; k < table_len; k += blockDim.x) s[k] = table[k];
  __syncthreads();

  const int n = width * height;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const int G = (int)s[0];
  const float* mats = s + HEADER + G * GEOM_STRIDE;
  const V3 pos = v3(s[2], s[3], s[4]);
  const V3 view = v3(s[5], s[6], s[7]);
  const V3 up = v3(s[8], s[9], s[10]);
  const V3 right = v3(s[11], s[12], s[13]);
  const float aperture = s[16], focal = s[17], shutter = s[18];
  const uint2 key = make_uint2(seed, 0u);
  const float it_f = (float)iteration;

  // ---- camera draws: AA x, AA y, lens r, lens phi, shutter time ----------
  float cu[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (sampler == SAMPLER_UNIFORMS) {
#pragma unroll
    for (int k = 0; k < 5; ++k) cu[k] = cam_u[(size_t)k * n + i];
  } else if (sampler == SAMPLER_STRATIFIED) {
    unsigned mix = (unsigned)i ^ (CAMERA_SLOT * 0x9E3779B9u);
    if (antialias) {
      cu[0] = lattice(it_f, R2A0, mix, SALT_AA);
      cu[1] = lattice(it_f, R2A1, mix, SALT_AA + 101u);
    }
    if (dof) {
      cu[2] = lattice(it_f, R2A0, mix, SALT_LENS);
      cu[3] = lattice(it_f, R2A1, mix, SALT_LENS + 101u);
    }
    if (motion) cu[4] = lattice(it_f, PHI_INV, mix, SALT_TIME);
  } else {
    uint4 r = philox4x32_10(make_uint4((unsigned)i, iteration, 0xFFFFFFFFu, 0u), key);
    cu[0] = u01(r.x);
    cu[1] = u01(r.y);
    cu[2] = u01(r.z);
    cu[3] = u01(r.w);
    if (motion) {
      r = philox4x32_10(make_uint4((unsigned)i, iteration, 0xFFFFFFFFu, 1u), key);
      cu[4] = u01(r.x);
    }
  }

  // ---- ray generation (src/pathtrace.cu:122-143) -------------------------
  float x = (float)(i % width), y = (float)(i / width);
  if (antialias) {
    x = x + cu[0];
    y = y + cu[1];
  }
  float sx = s[14] * (x - (float)width * 0.5f);
  float sy = s[15] * (y - (float)height * 0.5f);
  V3 d = normalize(v3(view.x - right.x * sx - up.x * sy,
                      view.y - right.y * sx - up.y * sy,
                      view.z - right.z * sx - up.z * sy));
  V3 o = pos;
  if (dof) {
    float r = sqrtf(cu[2]) * aperture;
    float phi = cu[3] * TWO_PI;
    float lr = r * cosf(phi), lu = r * sinf(phi);
    V3 o_dof = v3(o.x + right.x * lr + up.x * lu, o.y + right.y * lr + up.y * lu,
                  o.z + right.z * lr + up.z * lu);
    float f = fmaxf(focal, 1e-6f);
    V3 focus = v3(o.x + d.x * f, o.y + d.y * f, o.z + d.z * f);
    V3 d_dof = normalize(v3(focus.x - o_dof.x, focus.y - o_dof.y, focus.z - o_dof.z));
    if (aperture > 0.0f && focal > 0.0f) {
      o = o_dof;
      d = d_dof;
    }
  }
  const float tm = motion ? cu[4] * shutter : 0.0f;

  V3 thr = v3(1.0f, 1.0f, 1.0f);
  V3 rad = v3(0.0f, 0.0f, 0.0f);
  for (int b = 0; b < depth; ++b) {
    // ---- nearest hit (src/pathtrace.cu:176-199) --------------------------
    const V3 zero = v3(0.0f, 0.0f, 0.0f);
    Hit h = {BIG, zero, zero, zero, 0, true};
    for (int g = 0; g < G; ++g) hit_geom(s + HEADER + g * GEOM_STRIDE, o, d, tm, h);
    const bool hit_ok = h.t < BIG && h.t > 0.0f;
    const float* mp = mats + (hit_ok ? h.mat : 0) * MAT_STRIDE;
    const V3 albedo = v3(mp[0], mp[1], mp[2]);
    const float emit = mp[6];
    // emission ends the path; a miss ends it on the black background
    if (!hit_ok) break;
    if (emit > 0.0f) {
      rad.x += thr.x * albedo.x * emit;
      rad.y += thr.y * albedo.y * emit;
      rad.z += thr.z * albedo.z * emit;
      break;
    }

    // ---- this bounce's uniforms: u_lobe, u1, u2, u_fresnel --------------
    float ul, u1, u2, uf;
    if (sampler == SAMPLER_UNIFORMS) {
      const float* ub = u + (size_t)b * 4 * n + i;
      ul = ub[0];
      u1 = ub[(size_t)n];
      u2 = ub[(size_t)2 * n];
      uf = ub[(size_t)3 * n];
    } else if (sampler == SAMPLER_STRATIFIED) {
      unsigned mix = (unsigned)i ^ ((unsigned)b * 0x9E3779B9u);
      ul = lattice(it_f, R4A0, mix, SALT_BOUNCE);
      u1 = lattice(it_f, R4A1, mix, SALT_BOUNCE + 101u);
      u2 = lattice(it_f, R4A2, mix, SALT_BOUNCE + 202u);
      uf = lattice(it_f, R4A3, mix, SALT_BOUNCE + 303u);
    } else {
      uint4 r = philox4x32_10(make_uint4((unsigned)i, iteration, (unsigned)b, 0u), key);
      ul = u01(r.x);
      u1 = u01(r.y);
      u2 = u01(r.z);
      uf = u01(r.w);
    }

    // ---- scatter (src/interactions.h:44-79) -----------------------------
    const float ior = mp[9], p_refr = mp[10], p_spec = mp[11], p_diff = mp[12];
    const bool take_refr = ul < p_refr;
    const bool take_spec = !take_refr && ul < p_refr + p_spec;
    const V3 n_ = h.normal;
    const float k2 = 2.0f * dot(d, n_);
    const V3 d_spec = v3(d.x - k2 * n_.x, d.y - k2 * n_.y, d.z - k2 * n_.z);
    V3 nd;
    float fs;  // 1 / lobe probability
    bool transmit = false;
    if (take_refr) {
      const float safe_ior = fmaxf(ior, 1e-6f);
      const float eta = h.outside ? 1.0f / safe_ior : safe_ior;
      const float cos_i = fminf(fmaxf(-dot(d, n_), 0.0f), 1.0f);
      const float eta_i = h.outside ? 1.0f : ior;
      const float eta_t = h.outside ? ior : 1.0f;
      const float q = (eta_i - eta_t) / (eta_i + eta_t);
      const float r0 = q * q;
      const float om = 1.0f - cos_i;
      const float om2 = om * om;
      const float fres = r0 + (1.0f - r0) * (om * (om2 * om2));
      const float sin2_t = eta * eta * fmaxf(1.0f - cos_i * cos_i, 0.0f);
      const bool refl_instead = sin2_t > 1.0f || uf < fres;
      if (refl_instead) {
        nd = d_spec;
      } else {
        const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 1e-20f));
        const float k_r = eta * cos_i - cos_t;
        nd = v3(eta * d.x + k_r * n_.x, eta * d.y + k_r * n_.y,
                eta * d.z + k_r * n_.z);
        transmit = true;
      }
      fs = 1.0f / fmaxf(p_refr, 1e-6f);
    } else if (take_spec) {
      nd = d_spec;
      fs = 1.0f / fmaxf(p_spec, 1e-6f);
    } else {  // cosine hemisphere, src/interactions.h:10-42
      const float up_ = sqrtf(u1);
      const float over = sqrtf(fmaxf(1.0f - u1, 0.0f));
      const float around = u2 * TWO_PI;
      const bool px = fabsf(n_.x) < SQRT_OF_ONE_THIRD;
      const bool py = !px && fabsf(n_.y) < SQRT_OF_ONE_THIRD;
      const V3 not_n = v3(px ? 1.0f : 0.0f, py ? 1.0f : 0.0f,
                          (px || py) ? 0.0f : 1.0f);
      const V3 p1 = normalize(cross(n_, not_n));
      const V3 p2 = normalize(cross(n_, p1));
      const float c = cosf(around) * over, sn = sinf(around) * over;
      nd = v3(up_ * n_.x + c * p1.x + sn * p2.x, up_ * n_.y + c * p1.y + sn * p2.y,
              up_ * n_.z + c * p1.z + sn * p2.z);
      fs = 1.0f / fmaxf(p_diff, 1e-6f);
    }
    nd = normalize(nd);
    const V3 f = (take_refr || take_spec) ? v3(mp[3], mp[4], mp[5]) : albedo;
    thr = v3(thr.x * (f.x * fs), thr.y * (f.y * fs), thr.z * (f.z * fs));
    // transmitted rays start just past the exact surface point; reflected
    // and diffuse rays at the backed-off point
    if (transmit) {
      const float push = 2.0f * RAY_EPS;
      o = v3(h.surf.x + push * nd.x, h.surf.y + push * nd.y, h.surf.z + push * nd.z);
    } else {
      o = h.point;
    }
    d = nd;
  }

  float* a = accum + (size_t)3 * i;
  a[0] += rad.x;
  a[1] += rad.y;
  a[2] += rad.z;
}

}  // namespace

extern "C" int megakernel_iteration(float* accum, const float* table,
                                    int table_len, int width, int height,
                                    int depth, int antialias, int dof,
                                    int motion, int sampler,
                                    unsigned iteration, unsigned seed,
                                    const float* cam_u, const float* u,
                                    void* stream) {
  const int threads = 128;
  const int n = width * height;
  const int blocks = (n + threads - 1) / threads;
  megakernel<<<blocks, threads, (size_t)table_len * sizeof(float),
               (cudaStream_t)stream>>>(accum, table, table_len, width, height,
                                       depth, antialias, dof, motion, sampler,
                                       iteration, seed, cam_u, u);
  return (int)cudaGetLastError();
}

extern "C" const char* megakernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
