// Shared device code of the BVH traversal kernels (bvh8.cu: K2,
// bvh_binary.cu: K3/K4): the ray, the slab test, the Moller-Trumbore leaf
// and the output block. The plain torch versions are box_hits and
// leaf_phase in ops/pallas_bvh.py, with the same operation order.
//
// Every product and sum below is rounded on its own (__fmul_rn & co.):
// nvcc would otherwise contract them into fused multiply-adds, and an ulp
// moved near a Moller-Trumbore threshold (det 1e-12, t > 1e-6, bu+bv <= 1)
// flips whether a lane hits. Written this way a lane takes the plain
// version's decisions bit for bit, and so pops the same nodes.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace bvh {

constexpr int THREADS = 128;
constexpr int TRI_ROW = 24;  // v0 e1 e2 n0 n1 n2 (3 each), uv0 uv1 uv2 (2)

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

// Ray i of the planar [3, n] origin and direction blocks. 1/d is IEEE
// division (nvcc's default -prec-div=true), as torch's 1/x: a zero
// component gives +-inf.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ qo,
                                        const float* __restrict__ qd,
                                        int i, int n) {
  Ray r;
  r.ox = qo[i];
  r.oy = qo[n + i];
  r.oz = qo[2 * n + i];
  r.dx = qd[i];
  r.dy = qd[n + i];
  r.dz = qd[2 * n + i];
  r.ix = 1.0f / r.dx;
  r.iy = 1.0f / r.dy;
  r.iz = 1.0f / r.dz;
  return r;
}

// Does the ray enter the box before t_best?
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
__device__ __forceinline__ bool box_hit(const Ray& r, const float* b,
                                        float t_best) {
  const float t1x = mul(sub(b[0], r.ox), r.ix);
  const float t1y = mul(sub(b[1], r.oy), r.iy);
  const float t1z = mul(sub(b[2], r.oz), r.iz);
  const float t2x = mul(sub(b[3], r.ox), r.ix);
  const float t2y = mul(sub(b[4], r.oy), r.iy);
  const float t2z = mul(sub(b[5], r.oz), r.iz);
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

// Moller-Trumbore against triangles start..start+count-1, with the smooth
// normal and uv interpolated for a hit. Strictly nearer wins, so on an
// exact tie the first found stays.
__device__ __forceinline__ void leaf(const Ray& r,
                                     const float* __restrict__ tris,
                                     int start, int count, Hit& h) {
  for (int k = 0; k < count; ++k) {
    const float* t = tris + (size_t)(start + k) * TRI_ROW;
    const float v0x = __ldg(t + 0), v0y = __ldg(t + 1), v0z = __ldg(t + 2);
    const float e1x = __ldg(t + 3), e1y = __ldg(t + 4), e1z = __ldg(t + 5);
    const float e2x = __ldg(t + 6), e2y = __ldg(t + 7), e2z = __ldg(t + 8);
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
    if (ok && bu >= 0.0f && bv >= 0.0f && add(bu, bv) <= 1.0f &&
        tk > 1e-6f && tk < h.t) {
      const float bw = sub(sub(1.0f, bu), bv);
      h.t = tk;
      h.nx = add(add(mul(bw, __ldg(t + 9)), mul(bu, __ldg(t + 12))),
                 mul(bv, __ldg(t + 15)));
      h.ny = add(add(mul(bw, __ldg(t + 10)), mul(bu, __ldg(t + 13))),
                 mul(bv, __ldg(t + 16)));
      h.nz = add(add(mul(bw, __ldg(t + 11)), mul(bu, __ldg(t + 14))),
                 mul(bv, __ldg(t + 17)));
      h.u = add(add(mul(bw, __ldg(t + 18)), mul(bu, __ldg(t + 20))),
                mul(bv, __ldg(t + 22)));
      h.v = add(add(mul(bw, __ldg(t + 19)), mul(bu, __ldg(t + 21))),
                mul(bv, __ldg(t + 23)));
      h.tri = start + k;
    }
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
