// K2: nearest hit (or any hit) of object-space rays against one mesh's
// 8-wide BVH.
//
// Replaces the Pallas kernel _traverse8_kernel of
// project3_cuda_path_tracer_tpu/ops/bvh8.py, which walks one shared stack
// per packet of 2,048 rays and slab-tests a node's 8 children across the
// packet. Here each lane walks its own ray with its own stack over the fused
// node rows (ops/bvh8.py documents the layout): pop an entry; an interior
// node slab-tests its 8 children and pushes those the ray enters, far child
// first (by the ray's origin against the node's threshold), so the near one
// pops first; a leaf runs Moller-Trumbore on its <= 4 triangle rows.
//
// What bounds it on this card: the bytes it must move are the rays (28 B
// in, 28 B out, 4 B of pops) and the tree rows they read once (node rows of
// 512 B, triangle rows of 96 B; 3.5 MB of nodes and 7.9 MB of triangles for
// the 81,920-triangle blob, which stay in the 50 MB L2). What keeps it from
// that: each pop is a dependent chain (stack entry -> node row -> slab
// tests -> pushes), and the rays of one warp need different numbers of pops
// (on the mesh wavefronts most rays pop only the root, a few dozens of
// nodes), so in a one-thread-per-ray schedule a warp idles until its
// longest ray is done.
//
// What the design does about it:
//  - Persistent warps that refill finished lanes (the schedule the renderer
//    launches, PERSISTENT). The grid fills the card (SMs x resident blocks,
//    worked out once by the wrapper); each warp takes 32-ray chunks from a
//    4-byte counter (one atomicAdd per chunk, broadcast by __shfl_sync);
//    once at least REFILL lanes of the warp are idle, those lanes take the
//    chunk's next rays (ranked with __ballot_sync/__popc). A warp step is
//    one pop ("if-if"): popping interior nodes until a leaf is due
//    ("while-while", Aila and Laine 2009) was slower on the card. A ray's
//    pop order depends only on the ray, so outputs and pop counts do not
//    depend on the schedule. The first port's one thread per ray (GRID)
//    stays as a second instance of the same template, for the A/B and the
//    bitwise check.
//  - A dead lane (!(t_bound > 0), NaN included) writes its miss record (t =
//    t_bound, zero normal and uv, tri -1, 1 pop) without reading the tree:
//    exactly what the plain version gives, which pops the root and enters
//    no box.
//  - The stack is split by index: entries 0..S-1 live in shared memory,
//    laid out [S][THREADS] so that the lanes of a warp hit distinct banks;
//    entries S..STACK-1 in a local array. S = 24 covers the deepest stack
//    the blob's wavefronts reach (17; the `stats` output reports it); STACK
//    stays the bound ops/bvh8.pack_mesh8 asserts, so deeper trees stay
//    correct. A tiny-S instance exercises the overflow.
//  - A node row is read as 15 vector loads (three float4s per child pair,
//    two float4s of encodings, one float2 of axis and threshold), a
//    triangle row as three float4s per test, loaded before the previous
//    row's test, and three more per accepted hit (bvh_common.cuh).
//  - __launch_bounds__ caps registers at the fewest with no spills
//    (chip_smoke.py prints each instance's registers and spills).
//
// Interface (plain C, bound with ctypes by ops/bvh8.py): the six planar ray
// pointers ox..dz [n] f32 and t_bound [n] f32 (null: unbounded); nodes
// [B8, 128] f32; tris [T+8, 24] f32 (both 16-byte aligned); out [6, n] f32
// (t, nx, ny, nz, u, v); tri [n] i32 (-1 = miss); pops [n] i32 or null;
// stats null or 3 u64 (busy and total lane slots of the pop steps, and
// the deepest stack, added and maxed in). bvh8_traverse launches the
// renderer's instance; bvh8_traverse_grid and bvh8_traverse_tiny the A/B's
// and the overflow check's. Each launch returns cudaGetLastError();
// bvh8_attributes reads an instance's registers, local memory and
// occupancy.
#include "bvh_common.cuh"

namespace {

constexpr int THREADS = bvh::THREADS;
constexpr int STACK = 128;  // ops/bvh8.pack_mesh8 asserts the tree fits
constexpr int WIDTH = 8;
constexpr int ROW4 = 32;    // float4s per node row (128 floats)
constexpr int ENC4 = 12;    // child encodings, cols 48-55: float4s 12, 13
constexpr int AXIS2 = 28;   // axis and threshold, cols 56-57: float2 28

// Shared stack entries per lane: the main instance's, and the tiny one
// that only exercises the local overflow.
constexpr int S_MAIN = 24;
constexpr int S_TINY = 2;

// At least 8 resident blocks (1,024 threads) per SM: at most 64 registers a
// thread, the fewest with no spills in any instance (nvcc -Xptxas -v; 56,
// for 9 blocks, spills).
constexpr int MIN_BLOCKS = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;
// The persistent schedule refills a warp's idle lanes once at least this
// many of its 32 are idle (1-4 timed alike on the mesh wavefronts, 8 and
// more slower: PERF.md).
constexpr int REFILL = 2;

constexpr int PERSISTENT = 0;
constexpr int GRID = 1;

struct Params {
  const float* ox;
  const float* oy;
  const float* oz;
  const float* dx;
  const float* dy;
  const float* dz;
  const float* t_bound;
  int n;
  const float4* nodes;
  const float4* tris;
  float* out;
  int* tri;
  int* pops;
  unsigned* counter;
  unsigned long long* stats;
  // The launch tally, or null: the launch adds one to launches[0] and,
  // in the any-hit mode, to launches[1] (utils/launches.py).
  unsigned long long* launches;
};

// A lane's ray and its walk, kept in registers. Its stack: entries 0..S-1
// in the block's shared array at my[k * THREADS], entries S..STACK-1 in
// the local array `spill` (a separate array: inside the struct it would
// pull the whole lane into local memory).
struct Lane {
  bvh::Ray r;
  bvh::Hit h;
  int i, sp, pops;
};

// The block's busy and total lane slots and deepest stack, when the launch
// asks for `stats`.
__shared__ unsigned tally[3];

template <int S>
__device__ __forceinline__ void push(const Params& p, Lane& L, int* my,
                                     int* spill, int e) {
  if (L.sp < S) {
    my[L.sp * THREADS] = e;
  } else {
    spill[L.sp - S] = e;
  }
  ++L.sp;
  if (p.stats != nullptr) atomicMax(&tally[2], (unsigned)L.sp);
}

template <int S>
__device__ __forceinline__ int pop(Lane& L, const int* my,
                                   const int* spill) {
  --L.sp;
  ++L.pops;
  return L.sp < S ? my[L.sp * THREADS] : spill[L.sp - S];
}

__device__ __forceinline__ void finish(const Params& p, const Lane& L) {
  bvh::store(L.h, L.i, p.n, p.out, p.tri);
  if (p.pops != nullptr) p.pops[L.i] = L.pops;
}

// Take ray i; false (and its record written) for a dead lane.
template <int S>
__device__ __forceinline__ bool start(const Params& p, int i, Lane& L,
                                      int* my, int* spill) {
  const float tb = p.t_bound != nullptr ? __ldg(p.t_bound + i) : bvh::BIG;
  L.i = i;
  L.h = {tb, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1};
  L.pops = 1;
  if (!(tb > 0.0f)) {
    finish(p, L);
    return false;
  }
  L.r = bvh::make_ray(__ldg(p.ox + i), __ldg(p.oy + i), __ldg(p.oz + i),
                      __ldg(p.dx + i), __ldg(p.dy + i), __ldg(p.dz + i));
  L.pops = 0;
  L.sp = 0;
  push<S>(p, L, my, spill, 0);  // the root row
  return true;
}

// Slab-test the 8 children of node row e and push those the ray enters,
// the far child first.
template <int S>
__device__ __forceinline__ void interior(const Params& p, Lane& L, int* my,
                                         int* spill, int e) {
  const float4* row = p.nodes + (size_t)e * ROW4;
  const float4 ea = __ldg(row + ENC4), eb = __ldg(row + ENC4 + 1);
  const float2 at = __ldg(reinterpret_cast<const float2*>(row) + AXIS2);
  const int enc[WIDTH] = {(int)ea.x, (int)ea.y, (int)ea.z, (int)ea.w,
                          (int)eb.x, (int)eb.y, (int)eb.z, (int)eb.w};
  unsigned mask = 0;
#pragma unroll
  for (int k = 0; k < WIDTH / 2; ++k) {
    // children 2k and 2k+1: floats 12k..12k+11
    const float4 a = __ldg(row + 3 * k), b = __ldg(row + 3 * k + 1),
                 c = __ldg(row + 3 * k + 2);
    // An empty slot has encoding 0, the root row, which is never a child:
    // skip it explicitly (its NaN box is rejected too).
    if (enc[2 * k] != 0 &&
        bvh::box_hit(L.r, a.x, a.y, a.z, a.w, b.x, b.y, L.h.t))
      mask |= 1u << (2 * k);
    if (enc[2 * k + 1] != 0 &&
        bvh::box_hit(L.r, b.z, b.w, c.x, c.y, c.z, c.w, L.h.t))
      mask |= 2u << (2 * k);
  }
  // The children are sorted ascending along the node's axis; when the ray
  // starts below the threshold, slot 0 is nearest and is pushed last.
  const int axis = (int)at.x;
  const float oa = axis == 0 ? L.r.ox : (axis == 1 ? L.r.oy : L.r.oz);
  const bool rev = oa < at.y;
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) {
    const bool in = ((mask >> (rev ? WIDTH - 1 - j : j)) & 1u) != 0;
    const int c = rev ? enc[WIDTH - 1 - j] : enc[j];
    if (in && L.sp < STACK) push<S>(p, L, my, spill, c);
  }
}

template <bool ANY_HIT>
__device__ __forceinline__ void run_leaf(const Params& p, Lane& L, int e) {
  const int meta = -e - 2;  // start * 32 + count
  bvh::leaf(L.r, p.tris, meta >> 5, meta & 31, L.h);
  if (ANY_HIT && L.h.tri >= 0) L.sp = 0;  // the first accepted leaf ends it
}

// One pop of a live lane. False once the lane's ray is done (its record
// written).
template <bool ANY_HIT, int S>
__device__ __forceinline__ bool step(const Params& p, Lane& L, int* my,
                                     int* spill) {
  const int e = pop<S>(L, my, spill);
  if (e >= 0) {
    interior<S>(p, L, my, spill, e);
  } else {
    run_leaf<ANY_HIT>(p, L, e);
  }
  if (L.sp > 0) return true;
  finish(p, L);
  return false;
}

template <int SCHED, bool ANY_HIT, int S>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    traverse8_kernel(const __grid_constant__ Params p) {
  __shared__ int stack[S * THREADS];  // [S][THREADS]
  int* my = stack + threadIdx.x;
  if (threadIdx.x < 3) tally[threadIdx.x] = 0;
  if (p.launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(p.launches, 1ull);
    if (ANY_HIT) atomicAdd(p.launches + 1, 1ull);
  }
  __syncthreads();

  const unsigned lane = threadIdx.x & 31u;
  const bool count = p.stats != nullptr && lane == 0;
  Lane L;
  int spill[STACK - S];
  bool alive = false;

  if (SCHED == GRID) {  // one thread per ray
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < p.n) alive = start<S>(p, i, L, my, spill);
    for (;;) {
      const unsigned live = __ballot_sync(FULL, alive);
      if (!live) break;
      if (count) {
        atomicAdd(&tally[0], (unsigned)__popc(live));
        atomicAdd(&tally[1], 32u);
      }
      if (alive) alive = step<ANY_HIT, S>(p, L, my, spill);
    }
  } else {  // persistent warps over 32-ray chunks, refilling idle lanes
    const unsigned below = (1u << lane) - 1u;
    int base = 0, used = 32;  // the warp's chunk [base, base+32), `used` taken
    bool more = true;         // rays left on the counter
    for (;;) {
      unsigned live = __ballot_sync(FULL, alive);
      if (more && (live == 0 || 32 - __popc(live) >= REFILL)) {
        unsigned idle = ~live;
        while (idle && more) {
          if (used == 32) {
            unsigned b0 = 0;
            if (lane == 0) b0 = atomicAdd(p.counter, 32u);
            base = (int)__shfl_sync(FULL, b0, 0);
            used = 0;
            if (base >= p.n) {
              more = false;
              break;
            }
          }
          const int avail = min(32 - used, p.n - base - used);
          const unsigned rank = __popc(idle & below);
          const bool take = ((idle >> lane) & 1u) && (int)rank < avail;
          if (take) alive = start<S>(p, base + used + (int)rank, L, my, spill);
          used += min(__popc(idle), avail);
          // a lane that took a dead ray stays idle and takes the next one
          idle &= ~__ballot_sync(FULL, take && alive);
          if (base + used >= p.n) more = false;
        }
        live = __ballot_sync(FULL, alive);
      }
      if (!live) break;
      if (count) {
        atomicAdd(&tally[0], (unsigned)__popc(live));
        atomicAdd(&tally[1], 32u);
      }
      if (alive) alive = step<ANY_HIT, S>(p, L, my, spill);
    }
  }
  if (p.stats != nullptr) {
    __syncthreads();
    if (threadIdx.x < 2)
      atomicAdd(p.stats + threadIdx.x, (unsigned long long)tally[threadIdx.x]);
    if (threadIdx.x == 2)
      atomicMax(p.stats + 2, (unsigned long long)tally[2]);
  }
}

typedef void (*KernelFn)(const Params);

// The instances: 0 persistent (the renderer's), 1 grid (the first port's
// schedule), 2 persistent with the tiny shared stack (the overflow check).
KernelFn pick(int instance, int any_hit) {
  switch (instance) {
    case 0:
      return any_hit ? traverse8_kernel<PERSISTENT, true, S_MAIN>
                     : traverse8_kernel<PERSISTENT, false, S_MAIN>;
    case 1:
      return any_hit ? traverse8_kernel<GRID, true, S_MAIN>
                     : traverse8_kernel<GRID, false, S_MAIN>;
    case 2:
      return any_hit ? traverse8_kernel<PERSISTENT, true, S_TINY>
                     : traverse8_kernel<PERSISTENT, false, S_TINY>;
  }
  return nullptr;
}

Params make_params(const float* ox, const float* oy, const float* oz,
                   const float* dx, const float* dy, const float* dz,
                   const float* t_bound, int n, const float* nodes,
                   const float* tris, float* out, int* tri, int* pops,
                   unsigned long long* stats, unsigned long long* launches) {
  Params p;
  p.ox = ox;
  p.oy = oy;
  p.oz = oz;
  p.dx = dx;
  p.dy = dy;
  p.dz = dz;
  p.t_bound = t_bound;
  p.n = n;
  p.nodes = reinterpret_cast<const float4*>(nodes);
  p.tris = reinterpret_cast<const float4*>(tris);
  p.out = out;
  p.tri = tri;
  p.pops = pops;
  p.counter = nullptr;
  p.stats = stats;
  p.launches = launches;
  return p;
}

// A persistent instance. `blocks` is the grid that fills the card (SMs x
// bvh8_attributes' resident blocks, worked out once by the caller), cut to
// the blocks the rays need; `counter` is 4 bytes of device scratch (zeroed
// here, on `stream`).
int launch_persistent(KernelFn fn, const Params& p, int blocks,
                      unsigned* counter, void* stream) {
  if (fn == nullptr || blocks < 1) return (int)cudaErrorInvalidValue;
  if (p.n <= 0) return 0;
  const cudaError_t err =
      cudaMemsetAsync(counter, 0, sizeof(unsigned), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int needed = (p.n + THREADS - 1) / THREADS;
  Params q = p;
  q.counter = counter;
  fn<<<blocks < needed ? blocks : needed, THREADS, 0,
       (cudaStream_t)stream>>>(q);
  return (int)cudaGetLastError();
}

}  // namespace

// The renderer's schedule: persistent warps refilling idle lanes.
extern "C" int bvh8_traverse(const float* ox, const float* oy,
                             const float* oz, const float* dx,
                             const float* dy, const float* dz,
                             const float* t_bound, int n, const float* nodes,
                             const float* tris, int any_hit, float* out,
                             int* tri, int* pops, int blocks,
                             unsigned* counter, unsigned long long* stats,
                             unsigned long long* launches, void* stream) {
  return launch_persistent(
      pick(0, any_hit),
      make_params(ox, oy, oz, dx, dy, dz, t_bound, n, nodes, tris, out, tri,
                  pops, stats, launches),
      blocks, counter, stream);
}

// The same schedule with a 2-entry shared stack, so that deeper entries
// take the local overflow (the bitwise check only).
extern "C" int bvh8_traverse_tiny(const float* ox, const float* oy,
                                  const float* oz, const float* dx,
                                  const float* dy, const float* dz,
                                  const float* t_bound, int n,
                                  const float* nodes, const float* tris,
                                  int any_hit, float* out, int* tri,
                                  int* pops, int blocks, unsigned* counter,
                                  unsigned long long* stats,
                                  unsigned long long* launches, void* stream) {
  return launch_persistent(
      pick(2, any_hit),
      make_params(ox, oy, oz, dx, dy, dz, t_bound, n, nodes, tris, out, tri,
                  pops, stats, launches),
      blocks, counter, stream);
}

// The first port's schedule: one thread per ray (the A/B and the bitwise
// check only).
extern "C" int bvh8_traverse_grid(const float* ox, const float* oy,
                                  const float* oz, const float* dx,
                                  const float* dy, const float* dz,
                                  const float* t_bound, int n,
                                  const float* nodes, const float* tris,
                                  int any_hit, float* out, int* tri,
                                  int* pops, unsigned long long* stats,
                                  unsigned long long* launches,
                                  void* stream) {
  const KernelFn fn = pick(1, any_hit);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const Params p = make_params(ox, oy, oz, dx, dy, dz, t_bound, n, nodes,
                               tris, out, tri, pops, stats, launches);
  fn<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// out[0..4] = registers per thread, local bytes per thread (the stack's
// overflow array and any spills), max threads per block, resident blocks
// per SM, static shared bytes; of the instance (0 persistent, 1 grid, 2
// tiny stack) in the mode any_hit.
extern "C" int bvh8_attributes(int instance, int any_hit, int* out) {
  const KernelFn fn = pick(instance, any_hit);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                        0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = per_sm;
  out[4] = (int)a.sharedSizeBytes;
  return 0;
}
