// Shared device code of the BVH traversal kernels (bvh8.cu: K2,
// bvh_binary.cu: K3/K4): the ray, the slab test, the Moller-Trumbore leaf
// and the output block. The plain torch versions are box_hits and
// leaf_phase in ops/pallas_bvh.py, with the same operation order.
//
// Every product and sum below is rounded on its own (__fmul_rn & co.):
// nvcc would otherwise contract them into fused multiply-adds, and an ulp
// moved near a Moller-Trumbore threshold (det 1e-12, t > 1e-6, bu+bv <= 1)
// flips whether a lane hits. Written this way a lane takes the plain
// version's decisions bit for bit, and so visits the same nodes.
//
// Rows are read as 16-byte vectors: a triangle row (24 floats, 96 B) is six
// float4s, of which a test reads the first three (v0, e1, e2 and n0) and an
// accepted hit the other three. The callers hand over 16-byte aligned
// tables (the wrappers check it) that end in at least one zero pad row.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace bvh {

constexpr int THREADS = 128;
// v0 e1 e2 n0 n1 n2 (3 floats each), uv0 uv1 uv2 (2 each): 24 floats
constexpr int TRI_ROW4 = 6;  // float4s per triangle row
constexpr float BIG = 1e30f;  // an unbounded ray's t (ops/pallas_bvh.BIG)

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Nearest hit so far: t starts at the lane's bound and a miss keeps it.
struct Hit {
  float t, nx, ny, nz, u, v;
  int tri;
};

// A ray and its reciprocal direction. 1/d is IEEE division (nvcc's default
// -prec-div=true), as torch's 1/x: a zero component gives +-inf.
__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  r.ix = 1.0f / dx;
  r.iy = 1.0f / dy;
  r.iz = 1.0f / dz;
  return r;
}

// Does the ray enter the box lo..hi before t_best?
//
// fminf/fmaxf return the other operand when one is NaN, while torch.minimum
// and jnp.minimum return the NaN, after which every compare fails. A NaN
// arises from an empty 8-wide slot's NaN box, or from 0*inf when an
// axis-parallel ray's origin lies on a slab plane; in both the reference
// rejects the box, so a NaN rejects it here too.
//
// The predicate keeps its four terms: the JAX 8-wide kernel folds
// `tmax > 0` into `tmax >= max(tmin, FLT_MIN)`, exact only under the TPU's
// flush-to-zero; the H100 keeps subnormals. `t_best > 0` deadens lanes
// whose bound is <= 0 (terminated paths, padding).
__device__ __forceinline__ bool box_hit(const Ray& r, float lox, float loy,
                                        float loz, float hix, float hiy,
                                        float hiz, float t_best) {
  const float t1x = mul(sub(lox, r.ox), r.ix);
  const float t1y = mul(sub(loy, r.oy), r.iy);
  const float t1z = mul(sub(loz, r.oz), r.iz);
  const float t2x = mul(sub(hix, r.ox), r.ix);
  const float t2y = mul(sub(hiy, r.oy), r.iy);
  const float t2z = mul(sub(hiz, r.oz), r.iz);
  if (isnan(t1x) || isnan(t1y) || isnan(t1z) || isnan(t2x) || isnan(t2y) ||
      isnan(t2z)) {
    return false;
  }
  const float tmin =
      fmaxf(fminf(t1x, t2x), fmaxf(fminf(t1y, t2y), fminf(t1z, t2z)));
  const float tmax =
      fminf(fmaxf(t1x, t2x), fminf(fmaxf(t1y, t2y), fmaxf(t1z, t2z)));
  return tmax >= tmin && tmax > 0.0f && tmin < t_best && t_best > 0.0f;
}

// Moller-Trumbore of one triangle, row `index` at `t`, given its first
// three float4s (v0, e1, e2, n0); the smooth normal and uv are interpolated
// for a hit. Strictly nearer wins, so on an exact tie the first found stays.
__device__ __forceinline__ void tri_test(const Ray& r, float4 a, float4 b,
                                         float4 c,
                                         const float4* __restrict__ t,
                                         int index, Hit& h) {
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float pvx = sub(mul(r.dy, e2z), mul(r.dz, e2y));
  const float pvy = sub(mul(r.dz, e2x), mul(r.dx, e2z));
  const float pvz = sub(mul(r.dx, e2y), mul(r.dy, e2x));
  const float det = dot3(e1x, e1y, e1z, pvx, pvy, pvz);
  const bool ok = fabsf(det) > 1e-12f;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float tvx = sub(r.ox, v0x);
  const float tvy = sub(r.oy, v0y);
  const float tvz = sub(r.oz, v0z);
  const float bu = mul(dot3(tvx, tvy, tvz, pvx, pvy, pvz), inv_det);
  const float qvx = sub(mul(tvy, e1z), mul(tvz, e1y));
  const float qvy = sub(mul(tvz, e1x), mul(tvx, e1z));
  const float qvz = sub(mul(tvx, e1y), mul(tvy, e1x));
  const float bv = mul(dot3(r.dx, r.dy, r.dz, qvx, qvy, qvz), inv_det);
  const float tk = mul(dot3(e2x, e2y, e2z, qvx, qvy, qvz), inv_det);
  if (ok && bu >= 0.0f && bv >= 0.0f && add(bu, bv) <= 1.0f && tk > 1e-6f &&
      tk < h.t) {
    // n0 = c.yzw; n1 = d.xyz; n2 = d.w e.xy; uv0 = e.zw; uv1 = f.xy;
    // uv2 = f.zw
    const float4 d = __ldg(t + 3), e = __ldg(t + 4), f = __ldg(t + 5);
    const float bw = sub(sub(1.0f, bu), bv);
    h.t = tk;
    h.nx = add(add(mul(bw, c.y), mul(bu, d.x)), mul(bv, d.w));
    h.ny = add(add(mul(bw, c.z), mul(bu, d.y)), mul(bv, e.x));
    h.nz = add(add(mul(bw, c.w), mul(bu, d.z)), mul(bv, e.y));
    h.u = add(add(mul(bw, e.z), mul(bu, f.x)), mul(bv, f.z));
    h.v = add(add(mul(bw, e.w), mul(bu, f.y)), mul(bv, f.w));
    h.tri = index;
  }
}

// Moller-Trumbore against triangles start..start+count-1, in order, with
// row k+1's first three float4s loaded before row k's test, so that the
// loads of a leaf's rows overlap (the tables end in zero pad rows, so row
// start+count is always readable).
__device__ __forceinline__ void leaf(const Ray& r,
                                     const float4* __restrict__ tris,
                                     int start, int count, Hit& h) {
  const float4* t = tris + (size_t)start * TRI_ROW4;
  float4 a = __ldg(t), b = __ldg(t + 1), c = __ldg(t + 2);
  for (int k = 0; k < count; ++k, t += TRI_ROW4) {
    const float4 na = __ldg(t + TRI_ROW4), nb = __ldg(t + TRI_ROW4 + 1),
                 nc = __ldg(t + TRI_ROW4 + 2);
    tri_test(r, a, b, c, t, start + k, h);
    a = na;
    b = nb;
    c = nc;
  }
}

// out is [6, n]: t, nx, ny, nz, u, v; tri is [n].
__device__ __forceinline__ void store(const Hit& h, int i, int n,
                                      float* __restrict__ out,
                                      int* __restrict__ tri) {
  out[i] = h.t;
  out[n + i] = h.nx;
  out[2 * n + i] = h.ny;
  out[3 * n + i] = h.nz;
  out[4 * n + i] = h.u;
  out[5 * n + i] = h.v;
  tri[i] = h.tri;
}

}  // namespace bvh

extern "C" const char* bvh_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
