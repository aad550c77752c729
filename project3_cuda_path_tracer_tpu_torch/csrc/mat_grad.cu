// G1: the backward of the per-lane material gather, a deterministic
// per-material sum: out[m, c] = sum over lanes i with mat_id[i] == m of
// g_c[i], for C = 1 or 3 gradient planes.
//
// Replaces no TPU kernel. The forward `table[mat_id]`
// (ops/wavefront._mat_select) reads a table of a few materials once per
// lane; under autograd its backward is PyTorch's index_put_(accumulate=True),
// which sorts the indices and serialises each run of equal ones, so with 5
// materials in 640,000 lanes a handful of warps did all the work, ~57 ms a
// launch on an H100 (PERF.md). The JAX package leaves this to XLA.
//
// What bounds it on this card: memory traffic, one read of its inputs,
// n * (8 + 4C) bytes (12.8 MB for an [M,3] field at 640,000 lanes: 3.8 us
// at 3.35 TB/s). The design:
//   - Pass 1 (`mat_grad_partials`): block b owns the 2,048 lanes
//     [b * BLOCK_LANES, (b + 1) * BLOCK_LANES); thread t reads lanes
//     b * BLOCK_LANES + k * THREADS + t, k = 0..LANES_PER_THREAD-1 (every
//     load made before any is used, so each thread has 8 (1 + C) loads in
//     flight), and adds each lane's values into one register accumulator
//     per (material of its tile, plane) in k order. A block sums its
//     threads: a shuffle butterfly inside each warp, then the warps in
//     order, and writes one partial [M_tile x C] per chunk of lanes. A
//     table wider than a tile (MT materials, at most 48 / C) is tiled over
//     blocks: block x takes tile x % tiles of chunk x / tiles, so the
//     tiles of one chunk read the same lanes back to back, from L2.
//   - Pass 2 (`mat_grad_sum`): one block a value (m, c); thread j sums the
//     partials of chunks j, j + SUM_THREADS, ... in order, then the block
//     as in pass 1, and writes (not adds) out[m, c]: nothing to zero.
// No atomic on a value and a fixed order of summation, so the result does
// not change from run to run (the train graph's replays are held bit for
// bit against eager steps), and ops/matgrad.mat_grad_plain repeats the
// order in torch ops bit for bit. Every sum starts from +0.0f and a lane
// of another material adds +0.0f, which leaves a sum that is never -0.0f
// unchanged. The launch tally (utils/launches.py, slot `mat_grad`) is
// bumped once by pass 2 (a counter, not a value).
//
// Interface (plain C, bound with ctypes by ops/matgrad.py):
//   mat_grad_launch(c, mat_id [n] i64, g0, g1, g2 [n] f32 or null (a
//     null plane reads 0; g1, g2 unused for c = 1), n, m,
//     part [chunks * m * c] f32 scratch, out [m * c] f32, launches or null,
//     stream) -> cudaError_t (cudaGetLastError() after each launch).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANES_PER_THREAD = 8;
// Lanes a pass-1 block owns (ops/matgrad.BLOCK_LANES).
constexpr long long BLOCK_LANES = THREADS * LANES_PER_THREAD;
constexpr int SUM_THREADS = 256;
// Accumulators a pass-1 thread keeps in registers: MT * C of them.
constexpr int TILE_VALUES = 48;
constexpr unsigned FULL = 0xffffffffu;

template <int C>
struct Planes {
  const float* p[C];
};

// The warp's 32 values summed by the butterfly: lane 0 ends with
// ((v0 + v16) + (v8 + v24)) + ..., the halving order of the plain version.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  return s;
}

template <int C, int MT>
__global__ void __launch_bounds__(THREADS)
    mat_grad_partials(const long long* __restrict__ mat_id, Planes<C> g,
                      long long n, int m, int tiles,
                      float* __restrict__ part) {
  const int tile = blockIdx.x % tiles;
  const long long chunk = blockIdx.x / tiles;
  const int m0 = tile * MT;
  const long long first = chunk * BLOCK_LANES + threadIdx.x;

  long long ids[LANES_PER_THREAD];
  float v[LANES_PER_THREAD][C];
#pragma unroll
  for (int k = 0; k < LANES_PER_THREAD; ++k) {
    const long long i = first + (long long)k * THREADS;
    const bool in = i < n;
    ids[k] = in ? __ldg(mat_id + i) : -1;
#pragma unroll
    for (int c = 0; c < C; ++c)
      v[k][c] = in && g.p[c] != nullptr ? __ldg(g.p[c] + i) : 0.f;
  }

  float acc[MT][C];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.f;
#pragma unroll
  for (int k = 0; k < LANES_PER_THREAD; ++k) {
    // the lane's row in this tile, or -1
    const int rel =
        ids[k] >= m0 && ids[k] < m0 + MT ? (int)(ids[k] - m0) : -1;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const bool hit = rel == j;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[j][c] += hit ? v[k][c] : 0.f;
    }
  }

  __shared__ float red[WARPS][MT * C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float s = warp_sum(acc[j][c]);
      if (lane == 0) red[warp][j * C + c] = s;
    }
  __syncthreads();
  for (int q = threadIdx.x; q < MT * C; q += THREADS) {
    const int mat = m0 + q / C;
    if (mat >= m) continue;
    float s = red[0][q];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[w][q];
    part[(chunk * m + mat) * C + q % C] = s;
  }
}

__global__ void __launch_bounds__(SUM_THREADS)
    mat_grad_sum(const float* __restrict__ part, long long chunks, int values,
                 float* __restrict__ out, unsigned long long* launches) {
  // The launch tally, or null (utils/launches.py).
  if (launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(launches, 1ull);
  const int q = blockIdx.x;
  float s = 0.f;
  for (long long b = threadIdx.x; b < chunks; b += SUM_THREADS)
    s += part[b * values + q];
  __shared__ float red[SUM_THREADS / 32];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = red[0];
#pragma unroll
    for (int w = 1; w < SUM_THREADS / 32; ++w) t += red[w];
    out[q] = t;
  }
}

// The smallest tile of materials that holds m, or the widest.
template <int C>
int tile_for(int m) {
  constexpr int widest = TILE_VALUES / C;
  return m <= 8 ? 8 : m <= 16 ? 16 : widest;
}

template <int C, int MT>
cudaError_t launch_partials(const long long* mat_id, Planes<C> g, long long n,
                            int m, float* part, cudaStream_t stream) {
  const long long chunks = (n + BLOCK_LANES - 1) / BLOCK_LANES;
  const int tiles = (m + MT - 1) / MT;
  if (chunks * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  mat_grad_partials<C, MT>
      <<<(unsigned)(chunks * tiles), THREADS, 0, stream>>>(mat_id, g, n, m,
                                                           tiles, part);
  return cudaGetLastError();
}

template <int C>
cudaError_t partials(const long long* mat_id, Planes<C> g, long long n, int m,
                     float* part, cudaStream_t stream) {
  switch (tile_for<C>(m)) {
    case 8: return launch_partials<C, 8>(mat_id, g, n, m, part, stream);
    case 16: return launch_partials<C, 16>(mat_id, g, n, m, part, stream);
    default:
      return launch_partials<C, TILE_VALUES / C>(mat_id, g, n, m, part,
                                                 stream);
  }
}

}  // namespace

extern "C" int mat_grad_launch(int c, const long long* mat_id, const float* g0,
                               const float* g1, const float* g2, long long n,
                               int m, float* part, float* out,
                               unsigned long long* launches, void* stream) {
  if ((c != 1 && c != 3) || m <= 0 || n < 0 || out == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = (n + BLOCK_LANES - 1) / BLOCK_LANES;
  cudaError_t rc = cudaSuccess;
  if (chunks > 0) {
    if (mat_id == nullptr || part == nullptr) return cudaErrorInvalidValue;
    if (c == 1) {
      rc = partials<1>(mat_id, Planes<1>{{g0}}, n, m, part, s);
    } else {
      rc = partials<3>(mat_id, Planes<3>{{g0, g1, g2}}, n, m, part, s);
    }
    if (rc != cudaSuccess) return rc;
  }
  mat_grad_sum<<<m * c, SUM_THREADS, 0, s>>>(part, chunks, m * c, out,
                                             launches);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long mat_grad_block_lanes() { return BLOCK_LANES; }

extern "C" const char* mat_grad_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
