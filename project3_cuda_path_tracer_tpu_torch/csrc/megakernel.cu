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
// What bounds it on an H100: the FP32 issue rate. A live path segment costs
// ~110-130 FP32 operations per primitive test (7 tests on cornell) plus
// ~170 for the winner's attributes and the lobe, while a pixel moves only
// its 12 accumulator bytes in and out: at 800x800, depth 8, ~2.5 M live
// segments need ~2.7 GFLOP (0.04 ms at 67 TFLOP/s) against 15 MB (0.005 ms
// at 3.35 TB/s). What keeps it from that rate: paths end at different
// bounces, and a lane whose path has ended idles until its warp's last path
// ends; the scene's scalars are read one by one from shared memory, which
// issues a quarter as many instructions per clock as the FP32 units; and
// registers cap the threads an SM holds.
//
// What the design does about it:
//  - The path body is two device functions, `start_path` (camera draws, ray
//    generation, thin lens, shutter time) and `bounce` (one segment), over a
//    `PathState` in registers. Every draw is keyed on (pixel, iteration,
//    bounce), never on the lane, so the image does not depend on which lane
//    traces which pixel, and each pixel is traced once per launch by one
//    lane: no atomics on the accumulator, and both schedules below give
//    equal accumulators bit for bit.
//  - Persistent warps that refill dead lanes (the schedule the renderer
//    launches). The grid exactly fills the card (SMs x resident blocks);
//    each warp takes chunks of 32 pixels from one global counter (one
//    atomicAdd per chunk); between bounces, once at least REFILL of its
//    lanes are dead, those lanes start the chunk's next pixels (ranked with
//    __ballot_sync/__popc). The one-thread-per-pixel schedule of the first
//    port (`GRID`) stays as a second instance of the same template, for the
//    A/B and the bitwise check.
//  - The nearest-hit loop keeps only the distance and the winner's index;
//    the winner's surface point, world point and normal are computed once
//    after the loop, by the same expressions.
//  - Every geom record (40 floats from a 16-byte boundary) and material
//    record (16 floats) is read as float4 from shared memory, where every
//    lane of a warp reads the same record (a broadcast).
//  - The sampler and motion blur are template parameters: an instance holds
//    only its own draws, and no velocity shift without motion.
//  - __launch_bounds__ caps registers at the fewest without spills
//    (chip_smoke.py prints each instance's registers and spills).
//
// Random numbers, chosen by `SAMPLER`:
//   0 Philox4x32-10, key (seed, 0), counter (pixel, iteration, bounce, draw);
//     bounce 0xFFFFFFFF holds the camera draws;
//   1 the stratified lattice of ops/wavefront.stratified_planes, bit for bit
//     (the lattice sum is rounded op by op, as in torch);
//   2 injected uniforms: cam_u [5,N] and u [depth,4,N], row-major planes.
//
// C interface (bound with ctypes by ops/megakernel.py): megakernel_iteration
// (persistent) and megakernel_iteration_grid launch on `stream` without
// synchronising and return cudaGetLastError(); megakernel_attributes reads
// an instance's registers, local memory and occupancy.

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

constexpr int PERSISTENT = 0;
constexpr int GRID = 1;

constexpr int THREADS = 128;
// At least 6 resident blocks (768 threads) per SM: at most 80 registers a
// thread, the fewest with no spills in any instance (nvcc -Xptxas -v).
constexpr int MIN_BLOCKS = 6;
constexpr unsigned FULL = 0xFFFFFFFFu;
// The persistent schedule refills a warp's dead lanes once at least this
// many of its 32 are dead (a sweep of 1-32 on cornell 800x800 d8: PERF.md).
constexpr int REFILL = 4;

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
// A row-major 3x4 affine block as three float4 rows.
__device__ __forceinline__ V3 xform_pt(float4 r0, float4 r1, float4 r2, V3 p) {
  return v3(r0.x * p.x + r0.y * p.y + r0.z * p.z + r0.w,
            r1.x * p.x + r1.y * p.y + r1.z * p.z + r1.w,
            r2.x * p.x + r2.y * p.y + r2.z * p.z + r2.w);
}
__device__ __forceinline__ V3 xform_dir(float4 r0, float4 r1, float4 r2, V3 v) {
  return v3(r0.x * v.x + r0.y * v.y + r0.z * v.z,
            r1.x * v.x + r1.y * v.y + r1.z * v.z,
            r2.x * v.x + r2.y * v.y + r2.z * v.z);
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

// ---- launch arguments and the scene in shared memory ----------------------

struct Params {
  float* accum;
  const float* table;
  int table_len, width, height, depth, antialias, dof;
  unsigned iteration, seed;
  const float* cam_u;  // sampler 2 only
  const float* u;
  unsigned* counter;          // persistent: the next free pixel, zeroed
  unsigned long long* stats;  // optional: busy lane slots, lane slots
};

// Float4 views of the table (ops/megakernel.py): the header is 5 float4,
// geom g 10 float4 from 5 + 10g, material m 4 float4 from 5 + 10G + 4m.
__device__ __forceinline__ const float4* geom_rec(const float4* s4, int g) {
  return s4 + (HEADER + g * GEOM_STRIDE) / 4;
}
__device__ __forceinline__ const float4* mat_rec(const float4* s4, int G,
                                                 int m) {
  return s4 + (HEADER + G * GEOM_STRIDE + m * MAT_STRIDE) / 4;
}

struct PathState {
  V3 o, d, thr, rad;
  float tm;   // shutter time (0 without motion)
  int pixel;
  int b;      // bounce index
};

// ---- one primitive --------------------------------------------------------

__device__ __forceinline__ float nz(float c) {
  return fabsf(c) < 1e-12f ? (c < 0.0f ? -1e-12f : 1e-12f) : c;
}

// ops/wavefront._primitive_hit_planar up to the world distance: the object-
// space ray, the object-space hit, and for a cube the face normal (dead code
// where the caller does not read it).
struct LocalHit {
  V3 qo, qd, nl;
  float t_obj;
  bool hit, outside;
};

template <bool MOTION>
__device__ __forceinline__ V3 geom_vel(const float4* gr) {
  if (!MOTION) return v3(0.0f, 0.0f, 0.0f);
  const float4 w = gr[8];  // ivt[8], velocity
  return v3(w.y, w.z, w.w);
}

template <bool MOTION>
__device__ __forceinline__ LocalHit local_hit(const float4* gr, V3 o, V3 d,
                                              float tm) {
  LocalHit L;
  const bool cube = (int)gr[9].x == CUBE;
  V3 osh = o;
  if (MOTION) {
    const V3 vel = geom_vel<MOTION>(gr);
    osh = v3(o.x - vel.x * tm, o.y - vel.y * tm, o.z - vel.z * tm);
  }
  const float4 i0 = gr[0], i1 = gr[1], i2 = gr[2];
  L.qo = xform_pt(i0, i1, i2, osh);
  L.qd = normalize(xform_dir(i0, i1, i2, d));
  const V3 qo = L.qo, qd = L.qd;
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
    L.hit = (tmax >= tmin) && (tmax > 0.0f);
    L.outside = tmin > 0.0f;
    L.t_obj = L.outside ? tmin : tmax;
    bool ex = L.outside ? (tpx == tmin) : (tbx == tmax);
    bool ey = !ex && (L.outside ? (tpy == tmin) : (tby == tmax));
    bool ez = !(ex || ey);
    L.nl = v3(ex ? (t2x < t1x ? 1.0f : -1.0f) : 0.0f,
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
    L.t_obj = both_pos ? fminf(t1, t2) : fmaxf(t1, t2);
    L.hit = has_root && !both_neg;
    L.outside = both_pos;
    L.nl = v3(0.0f, 0.0f, 0.0f);
  }
  return L;
}

// Object-space point -> world (forward rows, then the velocity shift).
template <bool MOTION>
__device__ __forceinline__ V3 to_world(const float4* gr, V3 p, float tm) {
  V3 w = xform_pt(gr[3], gr[4], gr[5], p);
  if (MOTION) {
    const V3 vel = geom_vel<MOTION>(gr);
    w = v3(w.x + vel.x * tm, w.y + vel.y * tm, w.z + vel.z * tm);
  }
  return w;
}

// Hit points as fused multiply-adds (ops/wavefront._fma): in object space
// t*dir reaches ~1e3 on thin slabs, where a separately rounded product would
// eat the 1e-4 back-off.
__device__ __forceinline__ V3 ray_at(const LocalHit& L, float t) {
  return v3(fmaf(t, L.qd.x, L.qo.x), fmaf(t, L.qd.y, L.qo.y),
            fmaf(t, L.qd.z, L.qo.z));
}

// ---- the path -------------------------------------------------------------

template <int SAMPLER, bool MOTION>
__device__ __forceinline__ PathState start_path(const Params& p,
                                                const float4* s4, int i) {
  const int n = p.width * p.height;
  const float4 h1 = s4[1], h2 = s4[2], h3 = s4[3], h4 = s4[4];
  const float4 h0 = s4[0];
  const V3 pos = v3(h0.z, h0.w, h1.x);
  const V3 view = v3(h1.y, h1.z, h1.w);
  const V3 up = v3(h2.x, h2.y, h2.z);
  const V3 right = v3(h2.w, h3.x, h3.y);
  const float aperture = h4.x, focal = h4.y, shutter = h4.z;
  const float it_f = (float)p.iteration;

  // ---- camera draws: AA x, AA y, lens r, lens phi, shutter time ----------
  float cu[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (SAMPLER == SAMPLER_UNIFORMS) {
#pragma unroll
    for (int k = 0; k < 5; ++k) cu[k] = p.cam_u[(size_t)k * n + i];
  } else if (SAMPLER == SAMPLER_STRATIFIED) {
    unsigned mix = (unsigned)i ^ (CAMERA_SLOT * 0x9E3779B9u);
    if (p.antialias) {
      cu[0] = lattice(it_f, R2A0, mix, SALT_AA);
      cu[1] = lattice(it_f, R2A1, mix, SALT_AA + 101u);
    }
    if (p.dof) {
      cu[2] = lattice(it_f, R2A0, mix, SALT_LENS);
      cu[3] = lattice(it_f, R2A1, mix, SALT_LENS + 101u);
    }
    if (MOTION) cu[4] = lattice(it_f, PHI_INV, mix, SALT_TIME);
  } else {
    const uint2 key = make_uint2(p.seed, 0u);
    uint4 r = philox4x32_10(
        make_uint4((unsigned)i, p.iteration, 0xFFFFFFFFu, 0u), key);
    cu[0] = u01(r.x);
    cu[1] = u01(r.y);
    cu[2] = u01(r.z);
    cu[3] = u01(r.w);
    if (MOTION) {
      r = philox4x32_10(
          make_uint4((unsigned)i, p.iteration, 0xFFFFFFFFu, 1u), key);
      cu[4] = u01(r.x);
    }
  }

  // ---- ray generation (src/pathtrace.cu:122-143) -------------------------
  float x = (float)(i % p.width), y = (float)(i / p.width);
  if (p.antialias) {
    x = x + cu[0];
    y = y + cu[1];
  }
  float sx = h3.z * (x - (float)p.width * 0.5f);
  float sy = h3.w * (y - (float)p.height * 0.5f);
  V3 d = normalize(v3(view.x - right.x * sx - up.x * sy,
                      view.y - right.y * sx - up.y * sy,
                      view.z - right.z * sx - up.z * sy));
  V3 o = pos;
  if (p.dof) {
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
  PathState st;
  st.o = o;
  st.d = d;
  st.thr = v3(1.0f, 1.0f, 1.0f);
  st.rad = v3(0.0f, 0.0f, 0.0f);
  st.tm = MOTION ? cu[4] * shutter : 0.0f;
  st.pixel = i;
  st.b = 0;
  return st;
}

__device__ __forceinline__ void finish(const Params& p, const PathState& st) {
  float* a = p.accum + (size_t)3 * st.pixel;
  a[0] += st.rad.x;
  a[1] += st.rad.y;
  a[2] += st.rad.z;
}

// One segment of the path: nearest hit, emission or miss, the lobe, the
// next ray. Adds the path's radiance to the accumulator and returns false
// when the path ends.
template <int SAMPLER, bool MOTION>
__device__ __forceinline__ bool bounce(const Params& p, const float4* s4,
                                       int G, PathState& st) {
  const V3 o = st.o, d = st.d;
  const float tm = st.tm;
  // ---- nearest hit (src/pathtrace.cu:176-199), strict < ------------------
  float best_t = BIG;
  int best_g = 0;
  for (int g = 0; g < G; ++g) {
    const float4* gr = geom_rec(s4, g);
    const LocalHit L = local_hit<MOTION>(gr, o, d, tm);
    const V3 ipw = to_world<MOTION>(gr, ray_at(L, L.t_obj - RAY_EPS), tm);
    const V3 dw = v3(o.x - ipw.x, o.y - ipw.y, o.z - ipw.z);
    const float t_world = sqrtf(dot(dw, dw));
    if (L.hit && t_world < best_t) {
      best_t = t_world;
      best_g = g;
    }
  }
  // a miss ends the path on the black background
  if (!(best_t < BIG && best_t > 0.0f)) {
    finish(p, st);
    return false;
  }

  // ---- the winner's attributes, by the loop's expressions ----------------
  const float4* gr = geom_rec(s4, best_g);
  const LocalHit L = local_hit<MOTION>(gr, o, d, tm);
  const V3 ip = ray_at(L, L.t_obj - RAY_EPS);
  const V3 point = to_world<MOTION>(gr, ip, tm);
  const float4 ivt0 = gr[6], ivt1 = gr[7], ivt2 = gr[8];
  V3 nl = L.nl;
  if ((int)gr[9].x != CUBE) {
    const float flip = L.outside ? 1.0f : -1.0f;
    nl = v3(ip.x * flip, ip.y * flip, ip.z * flip);
  }
  const V3 n_ = normalize(v3(ivt0.x * nl.x + ivt0.y * nl.y + ivt0.z * nl.z,
                             ivt0.w * nl.x + ivt1.x * nl.y + ivt1.y * nl.z,
                             ivt1.z * nl.x + ivt1.w * nl.y + ivt2.x * nl.z));
  const bool outside = L.outside;

  const float4* mr = mat_rec(s4, G, (int)gr[9].y);
  const float4 m0 = mr[0], m1 = mr[1];
  const V3 albedo = v3(m0.x, m0.y, m0.z);
  const float emit = m1.z;
  // emission ends the path
  if (emit > 0.0f) {
    st.rad.x += st.thr.x * albedo.x * emit;
    st.rad.y += st.thr.y * albedo.y * emit;
    st.rad.z += st.thr.z * albedo.z * emit;
    finish(p, st);
    return false;
  }

  // ---- this bounce's uniforms: u_lobe, u1, u2, u_fresnel --------------
  const int i = st.pixel, b = st.b;
  float ul, u1, u2, uf;
  if (SAMPLER == SAMPLER_UNIFORMS) {
    const size_t n = (size_t)p.width * p.height;
    const float* ub = p.u + (size_t)b * 4 * n + i;
    ul = ub[0];
    u1 = ub[n];
    u2 = ub[2 * n];
    uf = ub[3 * n];
  } else if (SAMPLER == SAMPLER_STRATIFIED) {
    const float it_f = (float)p.iteration;
    unsigned mix = (unsigned)i ^ ((unsigned)b * 0x9E3779B9u);
    ul = lattice(it_f, R4A0, mix, SALT_BOUNCE);
    u1 = lattice(it_f, R4A1, mix, SALT_BOUNCE + 101u);
    u2 = lattice(it_f, R4A2, mix, SALT_BOUNCE + 202u);
    uf = lattice(it_f, R4A3, mix, SALT_BOUNCE + 303u);
  } else {
    uint4 r = philox4x32_10(make_uint4((unsigned)i, p.iteration, (unsigned)b, 0u),
                            make_uint2(p.seed, 0u));
    ul = u01(r.x);
    u1 = u01(r.y);
    u2 = u01(r.z);
    uf = u01(r.w);
  }

  // ---- scatter (src/interactions.h:44-79) -----------------------------
  const float4 m2 = mr[2];
  const float ior = m2.y, p_refr = m2.z, p_spec = m2.w;
  const bool take_refr = ul < p_refr;
  const bool take_spec = !take_refr && ul < p_refr + p_spec;
  const float k2 = 2.0f * dot(d, n_);
  const V3 d_spec = v3(d.x - k2 * n_.x, d.y - k2 * n_.y, d.z - k2 * n_.z);
  V3 nd;
  float fs;  // 1 / lobe probability
  bool transmit = false;
  if (take_refr) {
    const float safe_ior = fmaxf(ior, 1e-6f);
    const float eta = outside ? 1.0f / safe_ior : safe_ior;
    const float cos_i = fminf(fmaxf(-dot(d, n_), 0.0f), 1.0f);
    const float eta_i = outside ? 1.0f : ior;
    const float eta_t = outside ? ior : 1.0f;
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
    fs = 1.0f / fmaxf(mr[3].x, 1e-6f);  // p_diff
  }
  nd = normalize(nd);
  const V3 f = (take_refr || take_spec) ? v3(m0.w, m1.x, m1.y) : albedo;
  st.thr = v3(st.thr.x * (f.x * fs), st.thr.y * (f.y * fs),
              st.thr.z * (f.z * fs));
  // transmitted rays start just past the exact surface point; reflected
  // and diffuse rays at the backed-off point
  if (transmit) {
    const V3 surf = to_world<MOTION>(gr, ray_at(L, L.t_obj), tm);
    const float push = 2.0f * RAY_EPS;
    st.o = v3(surf.x + push * nd.x, surf.y + push * nd.y, surf.z + push * nd.z);
  } else {
    st.o = point;
  }
  st.d = nd;
  if (++st.b >= p.depth) {
    finish(p, st);
    return false;
  }
  return true;
}

// ---- the kernel: two schedules of one path body ---------------------------

template <int SCHED, int SAMPLER, bool MOTION>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
megakernel(const __grid_constant__ Params p) {
  extern __shared__ float4 s4[];
  __shared__ unsigned tally[2];  // the block's busy and total lane slots
  float* s = reinterpret_cast<float*>(s4);
  for (int k = threadIdx.x; k < p.table_len; k += blockDim.x) s[k] = p.table[k];
  if (threadIdx.x < 2) tally[threadIdx.x] = 0;
  __syncthreads();

  const int n = p.width * p.height;
  const int G = (int)s[0];
  const unsigned lane = threadIdx.x & 31u;
  const bool count = p.stats != nullptr && lane == 0;
  PathState st;
  bool alive;

  if (SCHED == GRID) {  // one thread per pixel
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    alive = i < n;
    if (alive) st = start_path<SAMPLER, MOTION>(p, s4, i);
    for (;;) {
      const unsigned live = __ballot_sync(FULL, alive);
      if (!live) break;
      if (count) {
        atomicAdd(&tally[0], (unsigned)__popc(live));
        atomicAdd(&tally[1], 32u);
      }
      if (alive) alive = bounce<SAMPLER, MOTION>(p, s4, G, st);
    }
  } else {  // persistent warps over 32-pixel chunks, refilling dead lanes
    const unsigned below = (1u << lane) - 1u;
    alive = false;
    int base = 0, used = 32;  // the warp's chunk [base, base+32), `used` taken
    bool more = true;         // pixels left on the counter
    for (;;) {
      unsigned live = __ballot_sync(FULL, alive);
      if (more && (live == 0 || 32 - __popc(live) >= REFILL)) {
        unsigned dead = ~live;
        while (dead && more) {
          if (used == 32) {
            unsigned b0 = 0;
            if (lane == 0) b0 = atomicAdd(p.counter, 32u);
            base = (int)__shfl_sync(FULL, b0, 0);
            used = 0;
            if (base >= n) {
              more = false;
              break;
            }
          }
          const int avail = min(32 - used, n - base - used);
          const unsigned rank = __popc(dead & below);
          const bool take = ((dead >> lane) & 1u) && (int)rank < avail;
          if (take) {
            st = start_path<SAMPLER, MOTION>(p, s4, base + used + (int)rank);
            alive = true;
          }
          used += min(__popc(dead), avail);
          dead &= ~__ballot_sync(FULL, take);
          if (base + used >= n) more = false;
        }
        live = __ballot_sync(FULL, alive);
      }
      if (!live) break;
      if (count) {
        atomicAdd(&tally[0], (unsigned)__popc(live));
        atomicAdd(&tally[1], 32u);
      }
      if (alive) alive = bounce<SAMPLER, MOTION>(p, s4, G, st);
    }
  }
  if (p.stats != nullptr) {
    __syncthreads();
    if (threadIdx.x < 2)
      atomicAdd(p.stats + threadIdx.x, (unsigned long long)tally[threadIdx.x]);
  }
}

typedef void (*KernelFn)(const Params);

template <int SCHED>
KernelFn pick(int sampler, int motion) {
  switch (sampler * 2 + (motion ? 1 : 0)) {
    case 0: return megakernel<SCHED, SAMPLER_PHILOX, false>;
    case 1: return megakernel<SCHED, SAMPLER_PHILOX, true>;
    case 2: return megakernel<SCHED, SAMPLER_STRATIFIED, false>;
    case 3: return megakernel<SCHED, SAMPLER_STRATIFIED, true>;
    case 4: return megakernel<SCHED, SAMPLER_UNIFORMS, false>;
    case 5: return megakernel<SCHED, SAMPLER_UNIFORMS, true>;
    default: return nullptr;
  }
}

KernelFn pick_any(int schedule, int sampler, int motion) {
  if (schedule == PERSISTENT) return pick<PERSISTENT>(sampler, motion);
  if (schedule == GRID) return pick<GRID>(sampler, motion);
  return nullptr;
}

Params make_params(float* accum, const float* table, int table_len,
                   int width, int height, int depth, int antialias, int dof,
                   unsigned iteration, unsigned seed, const float* cam_u,
                   const float* u, unsigned long long* stats) {
  Params p;
  p.accum = accum;
  p.table = table;
  p.table_len = table_len;
  p.width = width;
  p.height = height;
  p.depth = depth;
  p.antialias = antialias;
  p.dof = dof;
  p.iteration = iteration;
  p.seed = seed;
  p.cam_u = cam_u;
  p.u = u;
  p.counter = nullptr;
  p.stats = stats;
  return p;
}

}  // namespace

// The renderer's schedule: persistent warps refilling dead lanes. `blocks`
// is the grid that fills the card (SMs x megakernel_attributes' resident
// blocks, worked out once by the caller), cut to the blocks the image
// needs; `counter` is 4 bytes of device scratch (zeroed here, on `stream`);
// `stats`, when not null, gets the busy and total lane slots of the bounce
// steps added.
extern "C" int megakernel_iteration(float* accum, const float* table,
                                    int table_len, int width, int height,
                                    int depth, int antialias, int dof,
                                    int motion, int sampler,
                                    unsigned iteration, unsigned seed,
                                    const float* cam_u, const float* u,
                                    int blocks, unsigned* counter,
                                    unsigned long long* stats, void* stream) {
  const KernelFn fn = pick<PERSISTENT>(sampler, motion);
  if (fn == nullptr || blocks < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaMemsetAsync(counter, 0, sizeof(unsigned), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int needed = (width * height + THREADS - 1) / THREADS;
  if (blocks > needed) blocks = needed;
  Params p = make_params(accum, table, table_len, width, height, depth,
                         antialias, dof, iteration, seed, cam_u, u, stats);
  p.counter = counter;
  fn<<<blocks, THREADS, (size_t)table_len * sizeof(float),
       (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The first port's schedule: one thread per pixel (the A/B and the bitwise
// check only).
extern "C" int megakernel_iteration_grid(float* accum, const float* table,
                                         int table_len, int width, int height,
                                         int depth, int antialias, int dof,
                                         int motion, int sampler,
                                         unsigned iteration, unsigned seed,
                                         const float* cam_u, const float* u,
                                         unsigned long long* stats,
                                         void* stream) {
  const KernelFn fn = pick<GRID>(sampler, motion);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int n = width * height;
  const Params p = make_params(accum, table, table_len, width, height, depth,
                               antialias, dof, iteration, seed, cam_u, u,
                               stats);
  fn<<<(n + THREADS - 1) / THREADS, THREADS, (size_t)table_len * sizeof(float),
       (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// out[0..4] = registers per thread, local (spill) bytes per thread, max
// threads per block, resident blocks per SM with `smem_bytes` of table,
// static shared bytes; of the instance (schedule 0 persistent / 1 grid,
// sampler, motion).
extern "C" int megakernel_attributes(int schedule, int sampler, int motion,
                                     int smem_bytes, int* out) {
  const KernelFn fn = pick_any(schedule, sampler, motion);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                        (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = per_sm;
  out[4] = (int)a.sharedSizeBytes;
  return 0;
}

extern "C" const char* megakernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
