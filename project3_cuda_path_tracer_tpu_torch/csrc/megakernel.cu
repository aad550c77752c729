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
// Bit for bit with that chain on the card, as kernels I1 (csrc/prim_hit.cu)
// and S1 (csrc/shade.cu) are with their stages: every float operation is
// one IEEE-rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn),
// so that nvcc's default contraction cannot fuse a pair, in the chain's
// order (vec.dot's and vec.xform_pt's left-to-right sums); a division by a
// Python float as ATen computes it on CUDA, a product with the float
// reciprocal; `1.0 / x` as the reciprocal; the libdevice functions ATen's
// kernels call (sqrtf, rsqrtf, cosf, sinf, fmodf). Contracted, the kernel
// rendered cornell 0.29% darker than the chain (ROADMAP F11): the backed-
// off points off the rotated back wall landed inside it more often. Two
// operations take a cheaper form that gives the chain's result on every
// input the kernel meets:
//  - torch.minimum / maximum / clamp as fminf / fmaxf: they differ only on
//    a NaN operand, and a finite ray in a finite scene makes none;
//  - `_fma` (the chain's float64 product and sum, rounded to float32) as
//    fmaf: the two differ only where the float64 sum rounds onto a float32
//    halfway point (a double rounding), about one inexact sum in 2^29;
//    none showed over cornell's and cornell_glass's 800x800 frames
//    (PERF.md).
//
// What bounds it on an H100: the FP32 issue rate. A live path segment costs
// 70-94 FP32 operations per primitive test (7 tests on cornell), 36 more
// for each test that hits (about one a segment), ~160 for the winner's
// attributes and ~100-130 for the lobe, while a pixel moves only its 12
// accumulator bytes in and out: at 800x800, depth 8, ~2.5 M live segments
// need ~2.2 GFLOP (0.033 ms at 67 TFLOP/s; the hand counts are
// portbench/harness/roofline_k1.py's) against 15 MB (0.005 ms at
// 3.35 TB/s). What keeps it from that rate: paths end at different
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
//  - The bounce steps' busy and total lane slots (the busy ones are the
//    live segments traced) go to `stats` when the launch is given it (the
//    renderer's launches give the device tally's `k1_segments` and
//    `k1_slots`, utils/launches.py): each warp's first lane adds the
//    bounce's ballot count to a shared sum, and each block adds its sums
//    once at its end.
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

// the chain's Python floats as ATen takes them: rounded to float32
constexpr float BIG = 1e30f;
constexpr float RAY_EPS = 1e-4f;
constexpr float PUSH = static_cast<float>(2.0 * 1e-4);  // 2 * RAY_EPS
constexpr float NZ = 1e-12f;
constexpr float D2_FLOOR = static_cast<float>(1e-12);
constexpr float P_FLOOR = static_cast<float>(1e-6);
constexpr float COS_FLOOR = static_cast<float>(1e-20);
constexpr float TWO_PI = static_cast<float>(6.2831853071795864769);
constexpr float SQRT_OF_ONE_THIRD = static_cast<float>(0.5773502691896257645);

constexpr unsigned CAMERA_SLOT = 0x7FFFFFFFu;
constexpr unsigned SALT_AA = 0x68BC21EBu;
constexpr unsigned SALT_LENS = 0x51633E2Du;
constexpr unsigned SALT_TIME = 0x3504F333u;
constexpr unsigned SALT_BOUNCE = 0x2545F491u;
constexpr float R2A0 = 0.7548776662466927f, R2A1 = 0.5698402909980532f;
constexpr float R4A0 = 0.8566748838545029f, R4A1 = 0.7338918566271259f;
constexpr float R4A2 = 0.6287067210378086f, R4A3 = 0.5385972572236101f;
constexpr float PHI_INV = 0.6180339887498949f;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
// torch.clamp's (no operand is NaN: see above)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
// vec.dot: the terms summed left to right
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(sub(mul(a.y, b.z), mul(a.z, b.y)),
            sub(mul(a.z, b.x), mul(a.x, b.z)),
            sub(mul(a.x, b.y), mul(a.y, b.x)));
}
// vec.normalize: a * rsqrt(d2 > 1e-12 ? d2 : 1); near-zero vectors pass
// unscaled
__device__ __forceinline__ V3 normalize(V3 a) {
  const float d2 = dot(a, a);
  const float s = rsqrtf(d2 > D2_FLOOR ? d2 : 1.0f);
  return v3(mul(a.x, s), mul(a.y, s), mul(a.z, s));
}
// One row of vec.xform_pt / vec.xform_dir of a row-major 3x4 affine block.
__device__ __forceinline__ float row_pt(float4 r, V3 p) {
  return add(add(add(mul(r.x, p.x), mul(r.y, p.y)), mul(r.z, p.z)), r.w);
}
__device__ __forceinline__ float row_dir(float4 r, V3 v) {
  return add(add(mul(r.x, v.x), mul(r.y, v.y)), mul(r.z, v.z));
}
__device__ __forceinline__ V3 xform_pt(float4 r0, float4 r1, float4 r2, V3 p) {
  return v3(row_pt(r0, p), row_pt(r1, p), row_pt(r2, p));
}
__device__ __forceinline__ V3 xform_dir(float4 r0, float4 r1, float4 r2, V3 v) {
  return v3(row_dir(r0, v), row_dir(r1, v), row_dir(r2, v));
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
  return mul((float)(x >> 8), 1.0f / 16777216.0f);
}

// ops/wavefront._hash01 in native uint32
__device__ __forceinline__ float hash01(unsigned x, unsigned salt) {
  x ^= salt;
  x = (x ^ (x >> 16)) * 0x45D9F3Bu;
  x = (x ^ (x >> 16)) * 0x45D9F3Bu;
  x = x ^ (x >> 16);
  return mul((float)(x & 0x00FFFFFFu), 1.0f / 16777216.0f);
}
// One stratified_planes dimension: fmod(0.5 + it*alpha + hash, 1).
__device__ __forceinline__ float lattice(float it_f, float alpha,
                                         unsigned mix, unsigned salt) {
  return fmodf(add(add(0.5f, mul(it_f, alpha)), hash01(mix, salt)), 1.0f);
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

// wavefront._nz then `1.0 / c`: the reciprocal (times 1.0, exact)
__device__ __forceinline__ float inv_nz(float c) {
  return dvd(1.0f, fabsf(c) < NZ ? (c < 0.0f ? -NZ : NZ) : c);
}

// ops/wavefront._primitive_hit_planar up to the world distance: the
// velocity shift, the object-space ray, the object-space hit, and for a
// cube the face normal (dead code where the caller does not read it).
struct LocalHit {
  V3 qo, qd, nl, vt;
  float t_obj;
  bool hit, outside;
};

template <bool MOTION>
__device__ __forceinline__ LocalHit local_hit(const float4* gr, V3 o, V3 d,
                                              float tm) {
  LocalHit L;
  const bool cube = (int)gr[9].x == CUBE;
  V3 osh = o;
  L.vt = v3(0.0f, 0.0f, 0.0f);
  if (MOTION) {  // ivt[8], velocity
    const float4 w = gr[8];
    L.vt = v3(mul(w.y, tm), mul(w.z, tm), mul(w.w, tm));
    osh = v3(sub(o.x, L.vt.x), sub(o.y, L.vt.y), sub(o.z, L.vt.z));
  }
  const float4 i0 = gr[0], i1 = gr[1], i2 = gr[2];
  L.qo = xform_pt(i0, i1, i2, osh);
  L.qd = normalize(xform_dir(i0, i1, i2, d));
  const V3 qo = L.qo, qd = L.qd;
  if (cube) {  // _box_local_planar (src/intersections.h:48-90)
    const float ix = inv_nz(qd.x), iy = inv_nz(qd.y), iz = inv_nz(qd.z);
    const float t1x = mul(sub(-0.5f, qo.x), ix), t2x = mul(sub(0.5f, qo.x), ix);
    const float t1y = mul(sub(-0.5f, qo.y), iy), t2y = mul(sub(0.5f, qo.y), iy);
    const float t1z = mul(sub(-0.5f, qo.z), iz), t2z = mul(sub(0.5f, qo.z), iz);
    const float tax = fminf(t1x, t2x), tbx = fmaxf(t1x, t2x);
    const float tay = fminf(t1y, t2y), tby = fmaxf(t1y, t2y);
    const float taz = fminf(t1z, t2z), tbz = fmaxf(t1z, t2z);
    const float tpx = tax > 0.0f ? tax : -BIG;
    const float tpy = tay > 0.0f ? tay : -BIG;
    const float tpz = taz > 0.0f ? taz : -BIG;
    const float tmn = fmaxf(tpx, fmaxf(tpy, tpz));
    const float tmx = fminf(tbx, fminf(tby, tbz));
    L.hit = (tmx >= tmn) && (tmx > 0.0f);
    L.outside = tmn > 0.0f;
    L.t_obj = L.outside ? tmn : tmx;
    const bool ex = L.outside ? (tpx == tmn) : (tbx == tmx);
    const bool ey = !ex && (L.outside ? (tpy == tmn) : (tby == tmx));
    const bool ez = !(ex || ey);
    L.nl = v3(ex ? (t2x < t1x ? 1.0f : -1.0f) : 0.0f,
              ey ? (t2y < t1y ? 1.0f : -1.0f) : 0.0f,
              ez ? (t2z < t1z ? 1.0f : -1.0f) : 0.0f);
  } else {  // _sphere_local_planar, r = 0.5 (src/intersections.h:102-144)
    const float vdd = dot(qo, qd);
    const float radicand = sub(mul(vdd, vdd), sub(dot(qo, qo), 0.25f));
    const bool has_root = radicand >= 0.0f;
    const float s = sqrtf(has_root ? fmaxf(radicand, 0.0f) : 1.0f);
    const float t1 = add(-vdd, s), t2 = sub(-vdd, s);
    const bool both_neg = (t1 < 0.0f) && (t2 < 0.0f);
    const bool both_pos = (t1 > 0.0f) && (t2 > 0.0f);
    L.t_obj = both_pos ? fminf(t1, t2) : fmaxf(t1, t2);
    L.hit = has_root && !both_neg;
    L.outside = both_pos;
    L.nl = v3(0.0f, 0.0f, 0.0f);
  }
  return L;
}

// The object-space point at `t` on the ray (the chain's `_fma`, see above;
// into `*obj` when given), taken to the world by the forward rows and
// shifted back by the velocity.
template <bool MOTION>
__device__ __forceinline__ V3 world_at(const float4* gr, const LocalHit& L,
                                       float t, V3* obj = nullptr) {
  const V3 q = v3(__fmaf_rn(t, L.qd.x, L.qo.x), __fmaf_rn(t, L.qd.y, L.qo.y),
                  __fmaf_rn(t, L.qd.z, L.qo.z));
  if (obj != nullptr) *obj = q;
  V3 w = xform_pt(gr[3], gr[4], gr[5], q);
  if (MOTION) w = v3(add(w.x, L.vt.x), add(w.y, L.vt.y), add(w.z, L.vt.z));
  return w;
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
    x = add(x, cu[0]);
    y = add(y, cu[1]);
  }
  // `x - width * 0.5`: the Python float is exact in float32
  const float sx = mul(h3.z, sub(x, (float)p.width * 0.5f));
  const float sy = mul(h3.w, sub(y, (float)p.height * 0.5f));
  V3 d = normalize(v3(sub(sub(view.x, mul(right.x, sx)), mul(up.x, sy)),
                      sub(sub(view.y, mul(right.y, sx)), mul(up.y, sy)),
                      sub(sub(view.z, mul(right.z, sx)), mul(up.z, sy))));
  V3 o = pos;
  if (p.dof) {
    const float r = mul(sqrtf(cu[2]), aperture);
    const float phi = mul(cu[3], TWO_PI);
    const float lr = mul(r, cosf(phi)), lu = mul(r, sinf(phi));
    const V3 o_dof = v3(add(add(o.x, mul(right.x, lr)), mul(up.x, lu)),
                        add(add(o.y, mul(right.y, lr)), mul(up.y, lu)),
                        add(add(o.z, mul(right.z, lr)), mul(up.z, lu)));
    const float f = fmaxf(focal, P_FLOOR);
    const V3 focus = v3(add(o.x, mul(d.x, f)), add(o.y, mul(d.y, f)),
                        add(o.z, mul(d.z, f)));
    const V3 d_dof = normalize(v3(sub(focus.x, o_dof.x),
                                  sub(focus.y, o_dof.y),
                                  sub(focus.z, o_dof.z)));
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
  st.tm = MOTION ? mul(cu[4], shutter) : 0.0f;
  st.pixel = i;
  st.b = 0;
  return st;
}

__device__ __forceinline__ void finish(const Params& p, const PathState& st) {
  float* a = p.accum + (size_t)3 * st.pixel;
  a[0] = add(a[0], st.rad.x);
  a[1] = add(a[1], st.rad.y);
  a[2] = add(a[2], st.rad.z);
}

// One segment of the path: nearest hit, emission or miss, the lobe, the
// next ray (ops/wavefront.shade_planar's step, as kernel S1 runs it).
// Adds the path's radiance to the accumulator and returns false when the
// path ends. A miss collects nothing: the kernel's scenes have a black
// environment (ops/megakernel.supports).
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
    if (!L.hit) continue;  // its distance could not win
    const V3 ipw = world_at<MOTION>(gr, L, sub(L.t_obj, RAY_EPS));
    const float t_world =
        sqrtf(dot(v3(sub(o.x, ipw.x), sub(o.y, ipw.y), sub(o.z, ipw.z)),
                  v3(sub(o.x, ipw.x), sub(o.y, ipw.y), sub(o.z, ipw.z))));
    if (t_world < best_t) {
      best_t = t_world;
      best_g = g;
    }
  }
  // a miss (t marked -1, or a zero distance) ends the path on black
  if (!(best_t < BIG && best_t > 0.0f)) {
    finish(p, st);
    return false;
  }

  // ---- the winner's record, by the loop's expressions --------------------
  const float4* gr = geom_rec(s4, best_g);
  const LocalHit L = local_hit<MOTION>(gr, o, d, tm);
  V3 ip;
  const V3 point = world_at<MOTION>(gr, L, sub(L.t_obj, RAY_EPS), &ip);
  const float4 ivt0 = gr[6], ivt1 = gr[7], ivt2 = gr[8];
  V3 nl = L.nl;
  if ((int)gr[9].x != CUBE) {
    const float flip = L.outside ? 1.0f : -1.0f;
    nl = v3(mul(ip.x, flip), mul(ip.y, flip), mul(ip.z, flip));
  }
  // the inverse-transpose rows: ivt[0:3], ivt[3:6], ivt[6:9]
  const V3 n_ = normalize(v3(
      row_dir(make_float4(ivt0.x, ivt0.y, ivt0.z, 0.0f), nl),
      row_dir(make_float4(ivt0.w, ivt1.x, ivt1.y, 0.0f), nl),
      row_dir(make_float4(ivt1.z, ivt1.w, ivt2.x, 0.0f), nl)));
  const bool outside = L.outside;

  const float4* mr = mat_rec(s4, G, (int)gr[9].y);
  const float4 m0 = mr[0], m1 = mr[1];
  const V3 albedo = v3(m0.x, m0.y, m0.z);
  const float emit = m1.z;
  // emission ends the path: radiance += throughput * albedo * emittance
  if (emit > 0.0f) {
    st.rad = v3(add(st.rad.x, mul(mul(st.thr.x, albedo.x), emit)),
                add(st.rad.y, mul(mul(st.thr.y, albedo.y), emit)),
                add(st.rad.z, mul(mul(st.thr.z, albedo.z), emit)));
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

  // ---- scatter (src/interactions.h:44-79): the chosen lobe alone ---------
  // (the table holds p_refr, p_spec, p_diff as the chain computes them)
  const float4 m2 = mr[2];
  const float ior = m2.y, p_refr = m2.z, p_spec = m2.w;
  const bool take_refr = ul < p_refr;
  const bool take_spec = !take_refr && ul < add(p_refr, p_spec);
  V3 nd;
  float inv_p;  // 1 / the lobe's probability
  bool transmit = false;
  if (take_refr || take_spec) {
    // the mirror: reflect_planar
    const float k = mul(2.0f, dot(d, n_));
    nd = v3(sub(d.x, mul(k, n_.x)), sub(d.y, mul(k, n_.y)),
            sub(d.z, mul(k, n_.z)));
  }
  if (take_refr) {  // Fresnel (Schlick) and the refracted direction
    const float safe_ior = fmaxf(ior, P_FLOOR);
    const float eta = outside ? dvd(1.0f, safe_ior) : safe_ior;
    const float cos_i = clip(-dot(d, n_), 0.0f, 1.0f);
    const float eta_i = outside ? 1.0f : ior;
    const float eta_t = outside ? ior : 1.0f;
    const float q = dvd(sub(eta_i, eta_t), add(eta_i, eta_t));
    const float r0 = mul(q, q);
    const float om = sub(1.0f, cos_i);
    const float om2 = mul(om, om);
    const float fres = add(r0, mul(sub(1.0f, r0), mul(om, mul(om2, om2))));
    const float sin2_t =
        mul(mul(eta, eta), fmaxf(sub(1.0f, mul(cos_i, cos_i)), 0.0f));
    if (!(sin2_t > 1.0f || uf < fres)) {
      const float cos_t = sqrtf(fmaxf(sub(1.0f, sin2_t), COS_FLOOR));
      const float k_r = sub(mul(eta, cos_i), cos_t);
      nd = v3(add(mul(eta, d.x), mul(k_r, n_.x)),
              add(mul(eta, d.y), mul(k_r, n_.y)),
              add(mul(eta, d.z), mul(k_r, n_.z)));
      transmit = true;
    }
    inv_p = dvd(1.0f, fmaxf(p_refr, P_FLOOR));
  } else if (take_spec) {
    inv_p = dvd(1.0f, fmaxf(p_spec, P_FLOOR));
  } else {  // cosine_hemisphere_planar, src/interactions.h:10-42
    const float up_ = sqrtf(u1);
    const float over = sqrtf(fmaxf(sub(1.0f, u1), 0.0f));
    const float around = mul(u2, TWO_PI);
    const bool px = fabsf(n_.x) < SQRT_OF_ONE_THIRD;
    const bool py = !px && fabsf(n_.y) < SQRT_OF_ONE_THIRD;
    const V3 not_n = v3(px ? 1.0f : 0.0f, py ? 1.0f : 0.0f,
                        (px || py) ? 0.0f : 1.0f);
    const V3 p1 = normalize(cross(n_, not_n));
    const V3 p2 = normalize(cross(n_, p1));
    const float c = mul(cosf(around), over), sn = mul(sinf(around), over);
    nd = v3(add(add(mul(up_, n_.x), mul(c, p1.x)), mul(sn, p2.x)),
            add(add(mul(up_, n_.y), mul(c, p1.y)), mul(sn, p2.y)),
            add(add(mul(up_, n_.z), mul(c, p1.z)), mul(sn, p2.z)));
    inv_p = dvd(1.0f, fmaxf(mr[3].x, P_FLOOR));  // p_diff
  }
  nd = normalize(nd);
  const V3 f = (take_refr || take_spec) ? v3(m0.w, m1.x, m1.y) : albedo;
  st.thr = v3(mul(st.thr.x, mul(f.x, inv_p)), mul(st.thr.y, mul(f.y, inv_p)),
              mul(st.thr.z, mul(f.z, inv_p)));
  // transmitted rays start just past the exact surface point; reflected
  // and diffuse rays at the backed-off point
  if (transmit) {
    const V3 surf = world_at<MOTION>(gr, L, L.t_obj);
    st.o = v3(add(surf.x, mul(PUSH, nd.x)), add(surf.y, mul(PUSH, nd.y)),
              add(surf.z, mul(PUSH, nd.z)));
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
  // the bounce steps' tally, from each warp's first lane
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
