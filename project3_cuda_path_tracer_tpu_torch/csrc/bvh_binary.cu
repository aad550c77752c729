// K3 and K4: nearest hit of object-space rays against one mesh's binary
// skip-pointer BVH.
//
// Replaces the Pallas kernels of project3_cuda_path_tracer_tpu/ops/
// pallas_bvh.py: _traverse_kernel (K3, one shared cursor per 1,024-ray
// packet) and _traverse_kernel_sub (K4, one cursor per 128-lane row).
//   K3 (PACKET = false): one thread per ray with its own cursor.
//   K4 (PACKET = true):  one cursor per 32-lane warp. The warp descends
//       when __any_sync finds a lane that entered the box, and every lane
//       runs the leaf (a lane that did not enter is held off by its own
//       t_best). Outputs equal K3's.
// Walk: the cursor starts at the root (0) and runs while >= 0. Each node
// gets the slab test; a leaf that is entered runs <= LEAF_K
// Moller-Trumbore tests; the next node is cur+1 after an interior node
// that was entered, else the node's escape index `skip` (-1 ends).
//
// What bounds it on this card: the dependent chain node row -> slab test
// -> next cursor, one 32-byte node row and one 8-int row per step (two
// float4 and one int2 load); the binary tree has ~7x the nodes of the
// 8-wide one, so a ray takes more, shorter steps than in K2. The tables
// stay in L2. All tables must be 16-byte aligned (ops/pallas_bvh.py
// checks it).
//
// Interface (plain C, bound with ctypes by ops/pallas_bvh.py):
//   qo, qd [3, n] f32; t_bound [n] f32 (<= 0: a dead lane);
//   nodes_f [B, 8] f32 (lo, hi); nodes_i [B, 8] i32 (skip, meta =
//   start*16+count or -1); tris [T+1, 24] f32; sub != 0 picks K4;
//   out [6, n] f32 (t, nx, ny, nz, u, v); tri [n] i32 (-1 = miss).
//   Returns cudaGetLastError() after the launch.
#include "bvh_common.cuh"

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

template <bool PACKET>
__global__ void __launch_bounds__(bvh::THREADS)
    binary_kernel(const float* __restrict__ qo, const float* __restrict__ qd,
                  const float* __restrict__ t_bound, int n,
                  const float* __restrict__ nodes_f,
                  const int* __restrict__ nodes_i,
                  const float* __restrict__ tris, float* __restrict__ out,
                  int* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  // K4 keeps every lane of the last warp in the walk for __any_sync; a
  // lane past the end is dead (bound -1), as the Pallas padding is.
  if (!PACKET && !valid) return;
  bvh::Ray r = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
  bvh::Hit h = {-1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1};
  if (valid) {
    r = bvh::load_ray(qo, qd, i, n);
    h.t = t_bound[i];
  }

  // a node row is two float4s (lo.xyz hi.x, hi.yz pad) and one int2
  // (skip, meta); a triangle row six float4s
  const float4* nf4 = reinterpret_cast<const float4*>(nodes_f);
  const int2* ni2 = reinterpret_cast<const int2*>(nodes_i);
  const float4* tris4 = reinterpret_cast<const float4*>(tris);
  int cur = 0;
  while (cur >= 0) {
    const float4 a = __ldg(nf4 + 2 * (size_t)cur);
    const float4 b = __ldg(nf4 + 2 * (size_t)cur + 1);
    const int2 sm = __ldg(ni2 + 4 * (size_t)cur);
    const int skip = sm.x, meta = sm.y;
    bool enter = bvh::box_hit(r, a.x, a.y, a.z, a.w, b.x, b.y, h.t);
    if (PACKET) enter = __any_sync(FULL_MASK, enter);
    if (enter && meta >= 0) bvh::leaf(r, tris4, meta >> 4, meta & 15, h);
    cur = (enter && meta < 0) ? cur + 1 : skip;
  }
  if (valid) bvh::store(h, i, n, out, tri_out);
}

}  // namespace

extern "C" int bvh_binary_traverse(const float* qo, const float* qd,
                                   const float* t_bound, int n,
                                   const float* nodes_f, const int* nodes_i,
                                   const float* tris, int sub, float* out,
                                   int* tri, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + bvh::THREADS - 1) / bvh::THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sub) {
    binary_kernel<true><<<blocks, bvh::THREADS, 0, s>>>(
        qo, qd, t_bound, n, nodes_f, nodes_i, tris, out, tri);
  } else {
    binary_kernel<false><<<blocks, bvh::THREADS, 0, s>>>(
        qo, qd, t_bound, n, nodes_f, nodes_i, tris, out, tri);
  }
  return static_cast<int>(cudaGetLastError());
}
