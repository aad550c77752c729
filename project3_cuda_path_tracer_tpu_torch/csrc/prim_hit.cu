// I1: the nearest hit of a wavefront against a run of analytic primitives
// (CUBE and SPHERE geoms), with the whole hit record a lane keeps: t, the
// world normal, the material, the backed-off and the exact hit point, the
// uv, the inside/outside flag and, with `tangents`, dP/du.
//
// Replaces no Pallas kernel: the JAX package leaves this test to XLA's
// fusion of jnp (ops/wavefront.py's _primitive_hit_planar and the merge in
// intersect_planar). In the port that chain is ~240-265 torch kernels a
// geom a call, each reading and writing whole [N] planes, so a render
// bounce spent most of its device time there (PERF.md section 5).
//
// What bounds it on this card: memory traffic, one read of the rays and one
// write of the record: 28 B in a lane (origin, direction, time; 4 more with
// an occlusion bound) and 57 B out (t, normal, points, uv, an int64 material
// and a bool; 12 more with tangents), ~89 B a lane, 27 us at 1,048,576 lanes
// and 3.35 TB/s. The arithmetic (~150 FP32 and 6 FP64 operations a geom a
// lane) is far below the FP32 and FP64 peaks. The design:
//   - One thread owns one lane and keeps the best record in registers over
//     the run's geoms, in geom order, with the strict `<` merge of the chain
//     (the first of equal t wins), and writes each output plane once,
//     coalesced. The candidate's attributes past t are computed only where
//     it wins.
//   - A geom's row is the same for every lane: the block stages the rows of
//     up to STAGE geoms at a time in shared memory (the inverse, forward and
//     inverse-transpose transforms, velocity, material, type), read from the
//     geom tables through a device list of (index, type) pairs, so a graph
//     capture copies nothing from the host.
//   - Bit for bit with the torch chain on the card: every float operation is
//     one IEEE-rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, so that
//     nvcc's default contraction cannot fuse a pair), in the chain's order
//     (vec.xform_pt's left-to-right sums; `1.0 / x` as a reciprocal; a
//     division by a Python float as ATen computes it on CUDA, a product
//     with the float reciprocal); `_fma` as the chain's float64 product and
//     sum rounded to float32; the libdevice functions ATen's kernels call
//     (sqrtf, rsqrtf, atan2f, asinf); torch.minimum / maximum's NaN
//     propagation. ops/primhit.py's plain version is that chain.
//
// Interface (plain C, bound with ctypes by ops/primhit.py):
//   prim_hit_launch(n, rays [7] (ox, oy, oz, dx, dy, dz, time; f32 planes),
//     strides [7] (elements; 0 broadcasts one value), t_init [n] f32 or null
//     (the occlusion bound; null: BIG), in_rows [ROWS] f32 planes or null,
//     in_mat [n] i64, in_outside [n] u8 (the incoming record; null: the
//     miss record t_init, zeros, material 0, outside), run [2k] i64 (geom
//     index, type), k, inv, fwd, itr [G,4,4] f32, vel [G,3] f32, mat [G]
//     i32, tangents, out_t [n] f32, out [ROWS-1 or ROWS-4, n] f32, out_mat
//     [n] i64, out_outside [n] u8, launches or null, stream) -> cudaError_t.
//   The rows are ops/primhit.ROWS: t, nx, ny, nz, px, py, pz, sx, sy, sz,
//   u, v, then tx, ty, tz with tangents; t goes to a plane of its own (the
//   caller replaces it by the miss-marked t, and the record's other rows
//   stay held), the rest to `out` in that order.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// geoms staged in shared memory at a time
constexpr int STAGE = 64;
// scene/types.py
constexpr int CUBE = 1;  // any other type of a run is SPHERE (0)
constexpr int ROWS = 15;
constexpr int PLAIN_ROWS = 12;
constexpr int RAYS = 7;
// the chain's Python floats as ATen takes them: rounded to float32
constexpr float BIG = 1e30f;
constexpr float RAY_EPS = 1e-4f;
constexpr float NZ = 1e-12f;
constexpr float CLIP_LO = static_cast<float>(-1.0 + 1e-7);
constexpr float CLIP_HI = static_cast<float>(1.0 - 1e-7);
constexpr float TWO_PI_F = static_cast<float>(2.0 * 3.141592653589793);
constexpr float PI_F = static_cast<float>(3.141592653589793);

struct Geom {
  float inv[12];  // rows 0..2 of the inverse transform
  float fwd[12];  // rows 0..2 of the transform
  float itr[12];  // rows 0..2 of the inverse transpose
  float vel[3];
  int mat;
  int type;
};

struct Rec {
  float f[ROWS];
  long long mat;
  bool outside;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// torch.minimum / torch.maximum on CUDA: a NaN operand (the first one
// first) is returned as it is, else fminf / fmaxf
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}

// wavefront._fma: the float32 product is exact in float64, the sum rounds
// in float64, then to float32
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(c)));
}

// one row of vec.xform_pt / vec.xform_dir
__device__ __forceinline__ float row_pt(const float* m, float x, float y,
                                        float z) {
  return add(add(add(mul(m[0], x), mul(m[1], y)), mul(m[2], z)), m[3]);
}
__device__ __forceinline__ float row_dir(const float* m, float x, float y,
                                         float z) {
  return add(add(mul(m[0], x), mul(m[1], y)), mul(m[2], z));
}

__device__ __forceinline__ float dot3(float x, float y, float z) {
  return add(add(mul(x, x), mul(y, y)), mul(z, z));
}

// vec.normalize: a * rsqrt(d2 > 1e-12 ? d2 : 1)
__device__ __forceinline__ void normalize(float& x, float& y, float& z) {
  const float d2 = dot3(x, y, z);
  const float s = rsqrtf(d2 > NZ ? d2 : 1.0f);
  x = mul(x, s);
  y = mul(y, s);
  z = mul(z, s);
}

// wavefront._nz then `1.0 / c`: reciprocal, times 1.0 (exact)
__device__ __forceinline__ float inv_nz(float c) {
  const float nz = fabsf(c) < NZ ? (c < 0.f ? -NZ : NZ) : c;
  return __fdiv_rn(1.0f, nz);
}

// One geom against one lane (_primitive_hit_planar), merged into `best`
// when its t is below best's (intersect_planar's merge).
__device__ __forceinline__ void prim_test(const Geom& g, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float tm, bool tangents,
                                         Rec& best) {
  const float vtx = mul(g.vel[0], tm), vty = mul(g.vel[1], tm),
              vtz = mul(g.vel[2], tm);
  const float osx = sub(ox, vtx), osy = sub(oy, vty), osz = sub(oz, vtz);
  const float qox = row_pt(g.inv, osx, osy, osz);
  const float qoy = row_pt(g.inv + 4, osx, osy, osz);
  const float qoz = row_pt(g.inv + 8, osx, osy, osz);
  float qdx = row_dir(g.inv, dx, dy, dz);
  float qdy = row_dir(g.inv + 4, dx, dy, dz);
  float qdz = row_dir(g.inv + 8, dx, dy, dz);
  normalize(qdx, qdy, qdz);

  float t_obj;
  bool hit, outside;
  // the cube's face masks and local normal
  bool ex = false, ez = false;
  float nlx = 0.f, nly = 0.f, nlz = 0.f;
  if (g.type == CUBE) {
    // _box_local_planar
    const float ix = inv_nz(qdx), iy = inv_nz(qdy), iz = inv_nz(qdz);
    const float t1x = mul(sub(-0.5f, qox), ix), t1y = mul(sub(-0.5f, qoy), iy),
                t1z = mul(sub(-0.5f, qoz), iz);
    const float t2x = mul(sub(0.5f, qox), ix), t2y = mul(sub(0.5f, qoy), iy),
                t2z = mul(sub(0.5f, qoz), iz);
    const float tax = tmin(t1x, t2x), tay = tmin(t1y, t2y),
                taz = tmin(t1z, t2z);
    const float tbx = tmax(t1x, t2x), tby = tmax(t1y, t2y),
                tbz = tmax(t1z, t2z);
    const float tapx = tax > 0.f ? tax : -BIG, tapy = tay > 0.f ? tay : -BIG,
                tapz = taz > 0.f ? taz : -BIG;
    const float tmn = tmax(tapx, tmax(tapy, tapz));
    const float tmx = tmin(tbx, tmin(tby, tbz));
    hit = (tmx >= tmn) && (tmx > 0.f);
    outside = tmn > 0.f;
    t_obj = outside ? tmn : tmx;
    ex = outside ? tapx == tmn : tbx == tmx;
    const bool ey = !ex && (outside ? tapy == tmn : tby == tmx);
    ez = !(ex || ey);
    nlx = ex ? (t2x < t1x ? 1.f : -1.f) : 0.f;
    nly = ey ? (t2y < t1y ? 1.f : -1.f) : 0.f;
    nlz = ez ? (t2z < t1z ? 1.f : -1.f) : 0.f;
  } else {
    // _sphere_local_planar
    const float vdd = add(add(mul(qox, qdx), mul(qoy, qdy)), mul(qoz, qdz));
    const float rad = sub(mul(vdd, vdd), sub(dot3(qox, qoy, qoz), 0.25f));
    const bool has_root = rad >= 0.f;
    const float s = sqrtf(has_root ? tmax(rad, 0.f) : 1.f);
    const float t1 = add(-vdd, s), t2 = sub(-vdd, s);
    const bool both_neg = t1 < 0.f && t2 < 0.f;
    const bool both_pos = t1 > 0.f && t2 > 0.f;
    t_obj = both_pos ? tmin(t1, t2) : tmax(t1, t2);
    hit = has_root && !both_neg;
    outside = both_pos;
  }

  const float tb = sub(t_obj, RAY_EPS);
  const float ipx = fma64(tb, qdx, qox), ipy = fma64(tb, qdy, qoy),
              ipz = fma64(tb, qdz, qoz);
  const float pwx = add(row_pt(g.fwd, ipx, ipy, ipz), vtx);
  const float pwy = add(row_pt(g.fwd + 4, ipx, ipy, ipz), vty);
  const float pwz = add(row_pt(g.fwd + 8, ipx, ipy, ipz), vtz);
  const float t_world =
      sqrtf(dot3(sub(ox, pwx), sub(oy, pwy), sub(oz, pwz)));
  const float t = hit ? t_world : BIG;
  if (!(t < best.f[0])) return;

  const float sfx = fma64(t_obj, qdx, qox), sfy = fma64(t_obj, qdy, qoy),
              sfz = fma64(t_obj, qdz, qoz);
  float u, v, tnx = 0.f, tny = 0.f, tnz = 0.f;
  if (g.type == CUBE) {
    u = add(ex ? ipy : ipx, 0.5f);
    v = add(ez ? ipy : ipz, 0.5f);
    if (tangents) {
      // the x faces run u along object y, the others along object x
      const float ax = ex ? 0.f : 1.f, ay = ex ? 1.f : 0.f;
      tnx = row_dir(g.fwd, ax, ay, 0.f);
      tny = row_dir(g.fwd + 4, ax, ay, 0.f);
      tnz = row_dir(g.fwd + 8, ax, ay, 0.f);
    }
  } else {
    const float flip = outside ? 1.f : -1.f;
    nlx = mul(ipx, flip);
    nly = mul(ipy, flip);
    nlz = mul(ipz, flip);
    // `/ (2 * math.pi)` and `/ math.pi`: a product with the reciprocal;
    // `/ 0.5` a product with 2
    u = add(mul(atan2f(ipz, ipx), __fdiv_rn(1.0f, TWO_PI_F)), 0.5f);
    v = add(mul(asinf(tmin(tmax(mul(ipy, 2.0f), CLIP_LO), CLIP_HI)),
                __fdiv_rn(1.0f, PI_F)),
            0.5f);
    if (tangents) {
      tnx = row_dir(g.fwd, -ipz, 0.f, ipx);
      tny = row_dir(g.fwd + 4, -ipz, 0.f, ipx);
      tnz = row_dir(g.fwd + 8, -ipz, 0.f, ipx);
    }
  }
  float nx = row_dir(g.itr, nlx, nly, nlz);
  float ny = row_dir(g.itr + 4, nlx, nly, nlz);
  float nz = row_dir(g.itr + 8, nlx, nly, nlz);
  normalize(nx, ny, nz);

  best.f[0] = t;
  best.f[1] = nx;
  best.f[2] = ny;
  best.f[3] = nz;
  best.f[4] = pwx;
  best.f[5] = pwy;
  best.f[6] = pwz;
  best.f[7] = add(row_pt(g.fwd, sfx, sfy, sfz), vtx);
  best.f[8] = add(row_pt(g.fwd + 4, sfx, sfy, sfz), vty);
  best.f[9] = add(row_pt(g.fwd + 8, sfx, sfy, sfz), vtz);
  best.f[10] = u;
  best.f[11] = v;
  best.f[12] = tnx;
  best.f[13] = tny;
  best.f[14] = tnz;
  best.mat = g.mat;
  best.outside = outside;
}

struct Params {
  const float* rays[RAYS];
  long long strides[RAYS];
  const float* t_init;
  const float* in_rows[ROWS];
  const long long* in_mat;
  const unsigned char* in_outside;
  const long long* run;
  int k;
  const float* inv;
  const float* fwd;
  const float* itr;
  const float* vel;
  const int* mat;
  int tangents;
  long long n;
  float* out_t;
  float* out;
  long long* out_mat;
  unsigned char* out_outside;
  unsigned long long* launches;
};

__global__ void __launch_bounds__(THREADS) prim_hit_kernel(const Params p) {
  // The launch tally, or null (utils/launches.py).
  if (p.launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(p.launches, 1ull);
  __shared__ Geom stage[STAGE];
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < p.n;
  const bool tangents = p.tangents != 0;
  const int rows = tangents ? ROWS : PLAIN_ROWS;

  // (every loop over the record's rows is unrolled, so the record stays in
  // registers)
  float ray[RAYS];
  Rec best = {};
  if (live) {
#pragma unroll
    for (int c = 0; c < RAYS; ++c)
      ray[c] = __ldg(p.rays[c] + i * p.strides[c]);
    if (p.in_rows[0] != nullptr) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (r < rows) best.f[r] = __ldg(p.in_rows[r] + i);
      best.mat = __ldg(p.in_mat + i);
      best.outside = __ldg(p.in_outside + i) != 0;
    } else {
      // the miss record: t_init, zeros, material 0, outside
      best.f[0] = p.t_init != nullptr ? __ldg(p.t_init + i) : BIG;
      best.outside = true;
    }
  }

  for (int base = 0; base < p.k; base += STAGE) {
    const int count = min(STAGE, p.k - base);
    __syncthreads();  // the previous stage's rows are no longer read
    if (threadIdx.x < count) {
      const int g = (int)__ldg(p.run + 2 * (base + threadIdx.x));
      Geom& s = stage[threadIdx.x];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s.inv[4 * r + c] = __ldg(p.inv + 16 * g + 4 * r + c);
          s.fwd[4 * r + c] = __ldg(p.fwd + 16 * g + 4 * r + c);
          s.itr[4 * r + c] = __ldg(p.itr + 16 * g + 4 * r + c);
        }
#pragma unroll
      for (int c = 0; c < 3; ++c) s.vel[c] = __ldg(p.vel + 3 * g + c);
      s.mat = __ldg(p.mat + g);
      s.type = (int)__ldg(p.run + 2 * (base + threadIdx.x) + 1);
    }
    __syncthreads();
    if (live)
      for (int j = 0; j < count; ++j)
        prim_test(stage[j], ray[0], ray[1], ray[2], ray[3], ray[4], ray[5],
                  ray[6], tangents, best);
  }

  if (!live) return;
  p.out_t[i] = best.f[0];
#pragma unroll
  for (int r = 1; r < ROWS; ++r)
    if (r < rows) p.out[(r - 1) * p.n + i] = best.f[r];
  p.out_mat[i] = best.mat;
  p.out_outside[i] = best.outside ? 1 : 0;
}

}  // namespace

extern "C" int prim_hit_launch(
    long long n, const float* const* rays, const long long* strides,
    const float* t_init, const float* const* in_rows, const long long* in_mat,
    const unsigned char* in_outside, const long long* run, int k,
    const float* inv,
    const float* fwd, const float* itr, const float* vel, const int* mat,
    int tangents, float* out_t, float* out, long long* out_mat,
    unsigned char* out_outside, unsigned long long* launches, void* stream) {
  if (n <= 0 || k <= 0 || rays == nullptr || strides == nullptr ||
      run == nullptr || inv == nullptr || fwd == nullptr || itr == nullptr ||
      vel == nullptr || mat == nullptr || out_t == nullptr || out == nullptr ||
      out_mat == nullptr || out_outside == nullptr)
    return cudaErrorInvalidValue;
  Params p = {};
  for (int c = 0; c < RAYS; ++c) {
    if (rays[c] == nullptr) return cudaErrorInvalidValue;
    p.rays[c] = rays[c];
    p.strides[c] = strides[c];
  }
  p.t_init = t_init;
  if (in_rows != nullptr) {
    const int rows = tangents ? ROWS : PLAIN_ROWS;
    for (int r = 0; r < rows; ++r) {
      if (in_rows[r] == nullptr) return cudaErrorInvalidValue;
      p.in_rows[r] = in_rows[r];
    }
    if (in_mat == nullptr || in_outside == nullptr)
      return cudaErrorInvalidValue;
    p.in_mat = in_mat;
    p.in_outside = in_outside;
  }
  p.run = run;
  p.k = k;
  p.inv = inv;
  p.fwd = fwd;
  p.itr = itr;
  p.vel = vel;
  p.mat = mat;
  p.tangents = tangents;
  p.n = n;
  p.out_t = out_t;
  p.out = out;
  p.out_mat = out_mat;
  p.out_outside = out_outside;
  p.launches = launches;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  prim_hit_kernel<<<(unsigned)blocks, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int prim_hit_rows() { return ROWS; }

extern "C" const char* prim_hit_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
