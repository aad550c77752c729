// K2: nearest hit of object-space rays against one mesh's 8-wide BVH.
//
// Replaces the Pallas kernel _traverse8_kernel of
// project3_cuda_path_tracer_tpu/ops/bvh8.py (one shared stack per packet of
// 2,048 rays, 8 children slab-tested across the packet). Here each thread
// walks its own ray with its own stack of STACK int32 entries in local
// memory, over the fused node rows (ops/bvh8.py documents the layout).
//
// What bounds it on this card: dependent loads. Each pop reads one stack
// entry and then one node row (up to 58 of its 128 floats) or up to four
// 96-byte triangle rows before the next pop can start; the tables (3.5 MB
// of nodes, 7.9 MB of triangles for the 81,920-triangle blob) stay in the
// 50 MB L2. The design keeps the per-ray work small (near child popped
// first, so t_best prunes far subtrees) and leaves latency hiding to
// occupancy. Speed (short stacks in shared memory, ray regrouping,
// persistent threads) is later work.
//
// Interface (plain C, bound with ctypes by ops/bvh8.py):
//   qo, qd [3, n] f32; t_bound [n] f32 (<= 0: a dead lane);
//   nodes [B8, 128] f32; tris [T+8, 24] f32;
//   out [6, n] f32 (t, nx, ny, nz, u, v); tri [n] i32 (-1 = miss);
//   pops [n] i32 or null. Returns cudaGetLastError() after the launch.
#include "bvh_common.cuh"

namespace {

constexpr int STACK = 128;  // ops/bvh8.pack_mesh8 asserts the tree fits
constexpr int ROW = 128;
constexpr int WIDTH = 8;
constexpr int ENC = 48;     // child encodings, cols 48-55
constexpr int AXIS = 56;
constexpr int THRESHOLD = 57;

template <bool ANY_HIT>
__global__ void __launch_bounds__(bvh::THREADS)
    traverse8_kernel(const float* __restrict__ qo,
                     const float* __restrict__ qd,
                     const float* __restrict__ t_bound, int n,
                     const float* __restrict__ nodes,
                     const float* __restrict__ tris, float* __restrict__ out,
                     int* __restrict__ tri_out, int* __restrict__ pops_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bvh::Ray r = bvh::load_ray(qo, qd, i, n);
  bvh::Hit h = {t_bound[i], 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1};

  int stack[STACK];
  int sp = 0;
  int pops = 0;
  stack[sp++] = 0;  // the root row
  while (sp > 0) {
    const int e = stack[--sp];
    ++pops;
    if (e >= 0) {
      const float* row = nodes + (size_t)e * ROW;
      // Push far child first, so the near one pops first: the children
      // are sorted ascending along the node's axis; when the ray starts
      // below the threshold, slot 0 is nearest and is pushed last.
      const int axis = (int)__ldg(row + AXIS);
      const float oa = axis == 0 ? r.ox : (axis == 1 ? r.oy : r.oz);
      const bool rev = oa < __ldg(row + THRESHOLD);
      for (int j = 0; j < WIDTH; ++j) {
        const int c = rev ? WIDTH - 1 - j : j;
        const int enc = (int)__ldg(row + ENC + c);
        // An empty slot has encoding 0, the root row, which is never a
        // child: skip it explicitly (its NaN box is rejected too).
        if (enc == 0 || sp >= STACK) continue;
        if (bvh::box_hit(r, row + 6 * c, h.t)) stack[sp++] = enc;
      }
    } else {
      const int meta = -e - 2;  // start * 32 + count
      bvh::leaf(r, tris, meta >> 5, meta & 31, h);
      if (ANY_HIT && h.tri >= 0) break;
    }
  }
  bvh::store(h, i, n, out, tri_out);
  if (pops_out != nullptr) pops_out[i] = pops;
}

}  // namespace

extern "C" int bvh8_traverse(const float* qo, const float* qd,
                             const float* t_bound, int n, const float* nodes,
                             const float* tris, int any_hit, float* out,
                             int* tri, int* pops, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + bvh::THREADS - 1) / bvh::THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    traverse8_kernel<true><<<blocks, bvh::THREADS, 0, s>>>(
        qo, qd, t_bound, n, nodes, tris, out, tri, pops);
  } else {
    traverse8_kernel<false><<<blocks, bvh::THREADS, 0, s>>>(
        qo, qd, t_bound, n, nodes, tris, out, tri, pops);
  }
  return static_cast<int>(cudaGetLastError());
}
