// K3 and K4: nearest hit of object-space rays against one mesh's binary
// skip-pointer BVH.
//
// Replaces the Pallas kernels of project3_cuda_path_tracer_tpu/ops/
// pallas_bvh.py: _traverse_kernel (K3, one shared cursor per 1,024-ray
// packet) and _traverse_kernel_sub (K4, one cursor per 128-lane row). The
// walk of one ray: the cursor starts at the root (0) and runs while >= 0;
// each node gets the slab test; a leaf that is entered runs <= LEAF_K
// Moller-Trumbore tests; the next node is cur+1 after an interior node that
// was entered, else the node's escape index `skip` (-1 ends). A ray visits
// nodes in rising index order (skip-pointer DFS order), and its visits,
// leaf tests and answer depend only on the ray.
//
// What bounds it on this card: the bytes it must move are the rays (28 B in,
// 28 B out a live ray; 4 B in and 28 B out a dead one, whose bound is <= 0)
// and the tree rows they read once (32-byte node rows, 96-byte triangle
// rows; 1.6 MB of nodes and 7.9 MB of triangles for the 81,920-triangle
// blob, which stay in the 50 MB L2). What keeps it from that: a step is a
// dependent chain (node row -> slab test -> next cursor), a binary node
// tests one box where an 8-wide one tests eight, so a ray takes many short
// steps, and the rays of one warp need different numbers of steps (from 1
// to ~270 on the mesh wavefronts), so a warp of one ray per thread idles
// until its longest ray is done.
//
// What the design does about it:
//  - K3, one thread per ray (GRID): every ray starts at once, so a launch
//    lasts about as long as its longest rays' chains. Each lane loops on
//    its own; a warp vote per step (__ballot_sync, which the `stats` tally
//    needs) keeps the warp's lanes in lockstep and cost 12.5% of a
//    `pack_all` iteration (PERF.md), so only a launch that asks for the
//    tally takes it. (Persistent warps that refill finished lanes, K2's
//    schedule, lost to it on every bounce: PERF.md.)
//  - K4, warp packets of live rays (PACKET): a persistent warp (the grid
//    fills the card: SMs x resident blocks, worked out once by the
//    wrapper) takes 32-ray chunks from a 4-byte counter (one atomicAdd per
//    chunk, broadcast by __shfl_sync), answers their dead rays, and forms
//    a packet of the next 32 live rays in ray order (ranked with
//    __ballot_sync/__popc, moved with __shfl_sync), so neighbouring pixels
//    stay together. The packet walks
//    one shared cursor, the smallest node any of its lanes is due at
//    (__reduce_min_sync); a lane steps only when the cursor reaches its own
//    next node. A lane whose slab test fails at node X is thus masked off
//    until the cursor reaches skip(X), and runs a leaf only if it entered
//    that leaf itself: every lane's visits, leaf tests and answer are its
//    own K3 walk's, bit for bit. The lanes that step read the same row.
//  - A dead ray (!(t_bound > 0), NaN included) gets its miss record (t =
//    t_bound, zero normal and uv, tri -1, 1 step) without reading the tree:
//    exactly what the plain version gives, which reads the root and enters
//    nothing.
//  - One 32-byte node row a step: lo.xyz, hi.xyz, then skip and meta
//    bit-cast into the two pad floats, read as two float4s; the wrapper
//    builds it once at pack time from the JAX-layout tables nodes_f and
//    nodes_i (two 32-byte rows a step, which lost the A/B on every bounce:
//    PERF.md).
//  - The rays are read from the six planes as the caller holds them, with
//    no stacking copy.
//  - __launch_bounds__ caps registers at the fewest with no spills
//    (chip_smoke.py prints each instance's registers and spills).
// Every product and sum is rounded on its own (bvh_common.cuh), so each
// instance equals the plain version bit for bit, step counts included.
//
// Interface (plain C, bound with ctypes by ops/pallas_bvh.py): the six
// planar ray pointers ox..dz [n] f32 and t_bound [n] f32 (null: unbounded);
// nodes [B, 8] f32 (lo.xyz, hi.xyz, then skip and meta = start*16+count
// or -1 as i32 bits); tris [T+1, 24] f32 (both 16-byte aligned); out [6,
// n] f32 (t, nx, ny, nz, u, v); tri
// [n] i32 (-1 = miss); steps [n] i32 or null (node visits); stats null or
// 2 u64 (busy and total lane slots of the steps, added in).
// bvh_binary_traverse launches one instance (1 grid, 2 packet) and returns
// cudaGetLastError();
// bvh_binary_attributes reads an instance's registers, local memory and
// occupancy.
#include "bvh_common.cuh"

namespace {

constexpr int THREADS = bvh::THREADS;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int DONE = 0x7FFFFFFF;  // a K4 lane's next node once it is done

constexpr int GRID = 1;
constexpr int PACKET = 2;

// Resident blocks per SM that __launch_bounds__ asks for: the most with no
// spills (nvcc -Xptxas -v on sm_90a: the grid instance fits 64 registers,
// 8 blocks, and spills at 10 or 12 blocks, which ran slower; the packet
// instance uses 69 unbounded, and spills at 64, so 72 registers, 7
// blocks).
template <int SCHED>
constexpr int min_blocks() {
  return SCHED == GRID ? 8 : 7;
}

struct Params {
  const float* ox;
  const float* oy;
  const float* oz;
  const float* dx;
  const float* dy;
  const float* dz;
  const float* t_bound;
  int n;
  const float4* nodes;  // two float4s a row
  const float4* tris;
  float* out;
  int* tri;
  int* steps;
  unsigned* counter;
  unsigned long long* stats;
  // The launch tally, or null: the launch adds one to it
  // (utils/launches.py).
  unsigned long long* launches;
};

// A lane's ray and its walk, kept in registers: the next node `cur` (-1:
// the walk is over).
struct Lane {
  bvh::Ray r;
  bvh::Hit h;
  int i, steps, cur;
};

// The block's busy and total lane slots, when the launch asks for `stats`.
__shared__ unsigned tally[2];

__device__ __forceinline__ float bound_of(const Params& p, int i) {
  return p.t_bound != nullptr ? __ldg(p.t_bound + i) : bvh::BIG;
}

__device__ __forceinline__ void finish(const Params& p, const Lane& L) {
  bvh::store(L.h, L.i, p.n, p.out, p.tri);
  if (p.steps != nullptr) p.steps[L.i] = L.steps;
}

// The miss record of dead ray i (bound tb), written without the tree.
__device__ __forceinline__ void miss(const Params& p, int i, float tb) {
  const bvh::Hit h = {tb, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1};
  bvh::store(h, i, p.n, p.out, p.tri);
  if (p.steps != nullptr) p.steps[i] = 1;
}

// Start lane L on live ray i, whose bound is tb.
__device__ __forceinline__ void begin(const Params& p, int i, float tb,
                                      Lane& L) {
  L.i = i;
  L.h = {tb, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1};
  L.steps = 0;
  L.cur = 0;
  L.r = bvh::make_ray(__ldg(p.ox + i), __ldg(p.oy + i), __ldg(p.oz + i),
                      __ldg(p.dx + i), __ldg(p.dy + i), __ldg(p.dz + i));
}

// Take ray i at the root; false (and its record written) for a dead ray.
__device__ __forceinline__ bool start(const Params& p, int i, Lane& L) {
  const float tb = bound_of(p, i);
  if (!(tb > 0.0f)) {
    miss(p, i, tb);
    return false;
  }
  begin(p, i, tb, L);
  return true;
}

// Count one warp step: its busy lanes and its 32 lane slots.
__device__ __forceinline__ void count_step(const Params& p, bool leader,
                                           unsigned busy) {
  if (p.stats != nullptr && leader) {
    atomicAdd(&tally[0], (unsigned)__popc(busy));
    atomicAdd(&tally[1], 32u);
  }
}

// One node of a live lane's walk: the slab test, the leaf if it is one
// and the ray entered it. Returns the next node (-1 ends the walk).
__device__ __forceinline__ int visit(const Params& p, Lane& L, int cur) {
  const float4 a = __ldg(p.nodes + 2 * (size_t)cur);
  const float4 b = __ldg(p.nodes + 2 * (size_t)cur + 1);
  const int skip = __float_as_int(b.z);
  const int meta = __float_as_int(b.w);
  ++L.steps;
  const bool enter = bvh::box_hit(L.r, a.x, a.y, a.z, a.w, b.x, b.y, L.h.t);
  if (enter && meta >= 0) bvh::leaf(L.r, p.tris, meta >> 4, meta & 15, L.h);
  return (enter && meta < 0) ? cur + 1 : skip;
}

// One step of a live K3 lane. False once its ray is done (record written).
__device__ __forceinline__ bool step(const Params& p, Lane& L) {
  L.cur = visit(p, L, L.cur);
  if (L.cur >= 0) return true;
  finish(p, L);
  return false;
}

// The position of the n-th (from 0) set bit of m; n < __popc(m).
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const unsigned lo = m & ((1u << s) - 1u);
    const int c = __popc(lo);
    if (n >= c) {
      n -= c;
      m >>= s;
      pos += s;
    } else {
      m = lo;
    }
  }
  return pos;
}

// The warp's next 32-ray chunk from the counter (-1 once it is spent).
__device__ __forceinline__ int grab(const Params& p, unsigned lane) {
  unsigned b0 = 0;
  if (lane == 0) b0 = atomicAdd(p.counter, 32u);
  const int base = (int)__shfl_sync(FULL, b0, 0);
  return base < p.n ? base : -1;
}

template <int SCHED>
__global__ void __launch_bounds__(THREADS, min_blocks<SCHED>())
    binary_kernel(const __grid_constant__ Params p) {
  if (threadIdx.x < 2) tally[threadIdx.x] = 0;
  if (p.launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(p.launches, 1ull);
  __syncthreads();

  const unsigned lane = threadIdx.x & 31u;
  const bool leader = lane == 0;
  Lane L;

  if (SCHED == GRID) {  // K3, one thread per ray
    const int i = blockIdx.x * THREADS + threadIdx.x;
    bool alive = i < p.n && start(p, i, L);
    if (p.stats == nullptr) {  // no vote: see the header
      while (alive) alive = step(p, L);
    } else {
      for (;;) {
        const unsigned live = __ballot_sync(FULL, alive);
        if (!live) break;
        count_step(p, leader, live);
        if (alive) alive = step(p, L);
      }
    }
  } else {  // K4, packets of live rays walking one shared cursor
    int ci = 0;             // this lane's ray of the warp's chunk
    float ctb = 0.0f;       // its bound
    unsigned pending = 0;   // the chunk's live rays not yet in a packet
    bool more = true;
    for (;;) {
      // Fill slots [0, filled) with the next live rays in ray order.
      int filled = 0, si = 0;
      float stb = 0.0f;
      while (filled < 32 && more) {
        if (pending == 0) {
          const int base = grab(p, lane);
          if (base < 0) {
            more = false;
            break;
          }
          ci = base + (int)lane;
          bool live = false;
          if (ci < p.n) {
            ctb = bound_of(p, ci);
            live = ctb > 0.0f;
            if (!live) miss(p, ci, ctb);
          }
          pending = __ballot_sync(FULL, live);
          continue;
        }
        const int have = __popc(pending);
        const int take = min(have, 32 - filled);
        const int k = (int)lane - filled;
        const bool mine = k >= 0 && k < take;
        const int src = nth_bit(pending, mine ? k : 0);
        const int idx = __shfl_sync(FULL, ci, src);
        const float tb = __shfl_sync(FULL, ctb, src);
        if (mine) {
          si = idx;
          stb = tb;
        }
        pending = take == have
                      ? 0u
                      : pending & ~((1u << nth_bit(pending, take)) - 1u);
        filled += take;
      }
      if (filled == 0) break;
      int next = DONE;
      if ((int)lane < filled) {
        begin(p, si, stb, L);
        next = 0;
      }
      for (;;) {
        const int cur = __reduce_min_sync(FULL, next);
        if (cur == DONE) break;
        const bool due = next == cur;
        if (p.stats != nullptr) count_step(p, leader, __ballot_sync(FULL, due));
        if (due) {
          next = visit(p, L, cur);
          if (next < 0) {
            finish(p, L);
            next = DONE;
          }
        }
      }
    }
  }
  if (p.stats != nullptr) {
    __syncthreads();
    if (threadIdx.x < 2)
      atomicAdd(p.stats + threadIdx.x, (unsigned long long)tally[threadIdx.x]);
  }
}

typedef void (*KernelFn)(const Params);

// The instances: 1 grid (K3), 2 packet (K4).
KernelFn pick(int instance) {
  switch (instance) {
    case GRID: return binary_kernel<GRID>;
    case PACKET: return binary_kernel<PACKET>;
  }
  return nullptr;
}

}  // namespace

// One launch of instance `instance` (1 grid, 2 packet). The packet
// instance runs `blocks` blocks (SMs x bvh_binary_attributes' resident
// blocks, worked out once by the caller), cut to the blocks the rays need,
// and takes rays from `counter`, 4 bytes of device scratch zeroed here on
// `stream`; the grid instance ignores both.
extern "C" int bvh_binary_traverse(
    int instance, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* t_bound,
    int n, const float* nodes, const float* tris, float* out, int* tri,
    int* steps, int blocks, unsigned* counter, unsigned long long* stats,
    unsigned long long* launches, void* stream) {
  const KernelFn fn = pick(instance);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  p.steps = steps;
  p.counter = counter;
  p.stats = stats;
  p.launches = launches;
  const int needed = (n + THREADS - 1) / THREADS;
  if (instance == GRID) {
    fn<<<needed, THREADS, 0, s>>>(p);
  } else {
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), s);
    if (err != cudaSuccess) return (int)err;
    fn<<<blocks < needed ? blocks : needed, THREADS, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

// out[0..4] = registers per thread, local bytes per thread, max threads
// per block, resident blocks per SM, static shared bytes; of instance
// `instance`.
extern "C" int bvh_binary_attributes(int instance, int* out) {
  const KernelFn fn = pick(instance);
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
