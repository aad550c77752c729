// P2: the dependent-load probe, a loop of `steps` steps in which each step
// loads one row of a node-like table, folds scalars of it into a [16, 128]
// state, and derives the next row index from a sum over the state.
//
// Replaces the Pallas probe kernel `make(kind)` of
// tools/exp_extract_cost.py. Per step, with acc <- acc * 0.999 + x:
//   extract6   x = row[0..5], each folded into all 2,048 state elements;
//   extract48  x = row[0..47], the same;
//   vector8    state row r < 8 folds row[9r + j], j = 0..5 (the [8, 9]
//              view of the row); rows 8..15 stay.
// Then idx <- (int32(sum(state[0, :])) + step) mod rows.
//
// What bounds it on this card: latency. Only state row 0 decides the next
// index, and row 0 depends only on the table and on itself, so one step of
// the chain is: a row load (the 1.18 MB table of the probe stays in L2),
// the fold of row 0, a 128-lane sum, the index arithmetic. The design keeps
// everything else off that chain:
//   - every warp holds its own copy of row 0 (lane l: columns l, l+32,
//     l+64, l+96) and derives the same index sequence with no
//     communication: no shared memory and no barrier in the step loop;
//   - rows 1..15 are spread one element a lane over 60 more warps (4 a
//     block, several SMs), so a warp's own element adds one fold beside
//     the four of its row-0 copy at each scalar (vector8: six scalar loads
//     of its own row, issued with the row load, and six folds). Warp 0
//     owns row 0 and writes it out;
//   - the row is loaded once a warp, 18 lanes x float4 (288 bytes,
//     coalesced), and its scalars handed out by __shfl_sync;
//   - the 128-lane sum is the plain version's halving tree (a[l] + a[l + h]
//     for h = 64, 32, ..., 1): (a0 + a2) + (a1 + a3) in registers are its
//     levels 64 and 32, five __shfl_xor_sync butterflies the rest. At each
//     butterfly level lane l adds lane l ^ h; IEEE addition commutes, so
//     lane 0 computes exactly the tree's sum, and every lane holds it.
// Products and sums are rounded one by one (__fmul_rn, __fadd_rn: no FMA
// contraction) and the sum's truncation and mod are the C cast and %, as
// before, so the kernel and the plain version in
// tools/exp_extract_cost.py agree bit for bit: a single ulp in the sum
// could flip the truncated index and send the rest of the loop down other
// rows.
//
// Three more entries serve the chain floor that chip_smoke.py measures
// (`extract_cost_floor`, one warp each): a pointer chase over the table
// (per step a row load as above, one shuffle, one multiply and the index
// arithmetic), a dependent chain of __fmul_rn/__fadd_rn, and a dependent
// chain of __shfl_xor_sync.
//
// Interface (plain C, bound with ctypes by tools/exp_extract_cost.py):
//   extract_cost_run(table [rows, 72] f32, 16-byte aligned, rows,
//     state0 [16, 128] f32, out [16, 128] f32, steps, kind, stream), kind
//     0 = extract6, 1 = extract48, 2 = vector8;
//   extract_cost_floor(which, table, rows, n, sink [32] i32, stream),
//     which 0 = chase (n steps), 1 = fold chain (n folds), 2 = shuffle
//     chain (n shuffles).
// Both return cudaGetLastError() after the launch.
#include <cuda_runtime.h>

namespace {

constexpr int SUB = 16;
constexpr int LANES = 128;
constexpr int ROW = 72;
constexpr int ROW4 = ROW / 4;  // float4s a row
constexpr float DECAY = 0.999f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 4;
// Warp 0 holds row 0; warps 1..60 one element a lane of rows 1..15.
constexpr int WARPS = 1 + (SUB - 1) * LANES / 32;
constexpr int BLOCKS = (WARPS + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;

enum Kind { EXTRACT6 = 0, EXTRACT48 = 1, VECTOR8 = 2 };

__device__ __forceinline__ float fold(float acc, float x) {
  return __fadd_rn(__fmul_rn(acc, DECAY), x);
}

// Component j of v (a constant once the loop over j is unrolled).
__device__ __forceinline__ float part(float4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <int KIND>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
    extract_cost_kernel(const float* __restrict__ table, int rows,
                        const float* __restrict__ state0,
                        float* __restrict__ out, int steps) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (warp >= WARPS) return;
  const int r = warp == 0 ? 0 : 1 + (warp - 1) / 4;
  const int own = r * LANES + ((warp - 1) & 3) * 32 + lane;
  if (warp != 0 && KIND == VECTOR8 && r >= 8) {  // rows 8..15 stay
    out[own] = state0[own];
    return;
  }
  float a[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q] = state0[lane + 32 * q];
  float o = warp != 0 ? state0[own] : 0.0f;

  const float4* tab4 = reinterpret_cast<const float4*>(table);
  const int col = lane < ROW4 ? lane : 0;
  int idx = 0;
  for (int step = 0; step < steps; ++step) {
    const float4 v = __ldg(tab4 + (size_t)idx * ROW4 + col);
    float y[6];  // vector8: this warp's row's six scalars, loaded alongside
    if (KIND == VECTOR8) {
#pragma unroll
      for (int j = 0; j < 6; ++j)
        y[j] = __ldg(table + (size_t)idx * ROW + 9 * r + j);
    }
    constexpr int K = KIND == EXTRACT48 ? 48 : 6;  // vector8: row 0's six
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float x = __shfl_sync(FULL, part(v, k & 3), k >> 2);
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = fold(a[q], x);
      if (KIND != VECTOR8) o = fold(o, x);
    }
    if (KIND == VECTOR8) {
#pragma unroll
      for (int j = 0; j < 6; ++j) o = fold(o, y[j]);
    }
    float s = __fadd_rn(__fadd_rn(a[0], a[2]), __fadd_rn(a[1], a[3]));
#pragma unroll
    for (int h = 16; h > 0; h >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(FULL, s, h));
    const int nxt = ((int)s + step) % rows;  // truncation, like astype
    idx = nxt < 0 ? nxt + rows : nxt;
  }
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) out[lane + 32 * q] = a[q];
  } else {
    out[own] = o;
  }
}

// The chain floor's terms, one warp each; `sink` keeps the result live.
__global__ void chase_kernel(const float* __restrict__ table, int rows,
                             int n, int* sink) {
  const int lane = threadIdx.x;
  const float4* tab4 = reinterpret_cast<const float4*>(table);
  const int col = lane < ROW4 ? lane : 0;
  int idx = 0;
  for (int step = 0; step < n; ++step) {
    const float4 v = __ldg(tab4 + (size_t)idx * ROW4 + col);
    const float x = __shfl_sync(FULL, v.x, 0);
    const int nxt = ((int)__fmul_rn(x, 65536.0f) + step) % rows;
    idx = nxt < 0 ? nxt + rows : nxt;
  }
  sink[lane] = idx;
}

__global__ void fold_chain_kernel(float x, int n, int* sink) {
  float a = x + threadIdx.x;
#pragma unroll 8
  for (int i = 0; i < n; ++i) a = fold(a, x);
  sink[threadIdx.x] = __float_as_int(a);
}

__global__ void shfl_chain_kernel(int x, int n, int* sink) {
  int v = x + threadIdx.x;
#pragma unroll 8
  for (int i = 0; i < n; ++i) v = __shfl_xor_sync(FULL, v, 1);
  sink[threadIdx.x] = v;
}

}  // namespace

extern "C" int extract_cost_run(const float* table, int rows,
                                const float* state0, float* out, int steps,
                                int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int T = WARPS_PER_BLOCK * 32;
  if (kind == EXTRACT6) {
    extract_cost_kernel<EXTRACT6><<<BLOCKS, T, 0, s>>>(table, rows, state0,
                                                       out, steps);
  } else if (kind == EXTRACT48) {
    extract_cost_kernel<EXTRACT48><<<BLOCKS, T, 0, s>>>(table, rows, state0,
                                                        out, steps);
  } else if (kind == VECTOR8) {
    extract_cost_kernel<VECTOR8><<<BLOCKS, T, 0, s>>>(table, rows, state0,
                                                      out, steps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int extract_cost_floor(int which, const float* table, int rows,
                                  int n, int* sink, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    chase_kernel<<<1, 32, 0, s>>>(table, rows, n, sink);
  } else if (which == 1) {
    fold_chain_kernel<<<1, 32, 0, s>>>(0.5f, n, sink);
  } else if (which == 2) {
    shfl_chain_kernel<<<1, 32, 0, s>>>(1, n, sink);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* extract_cost_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
