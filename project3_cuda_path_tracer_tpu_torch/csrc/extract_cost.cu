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
// What bounds it on this card: latency. One step is a chain: a row load
// (the 1.18 MB table of the probe stays in L2), the fold, a 128-lane sum,
// and a barrier before the next load can be addressed. One CTA runs it;
// thread l owns lane column l of the state (16 values in registers). The
// products and sums are rounded one by one (__fmul_rn, __fadd_rn: no FMA
// contraction) and the sum is taken in a fixed tree, halving 128 lanes to
// 1 (a[l] + a[l + h] for h = 64, 32, ..., 1), which the plain version in
// tools/exp_extract_cost.py computes the same way, so the two agree bit
// for bit: a single ulp in the sum could flip the truncated index and send
// the rest of the loop down other rows.
//
// Interface (plain C, bound with ctypes by tools/exp_extract_cost.py):
//   table [rows, 72] f32; state0 [16, 128] f32; out [16, 128] f32;
//   kind 0 = extract6, 1 = extract48, 2 = vector8. Returns
//   cudaGetLastError() after the launch.
#include <cuda_runtime.h>

namespace {

constexpr int SUB = 16;
constexpr int LANES = 128;
constexpr int ROW = 72;
constexpr float DECAY = 0.999f;

enum Kind { EXTRACT6 = 0, EXTRACT48 = 1, VECTOR8 = 2 };

__device__ __forceinline__ float fold(float acc, float x) {
  return __fadd_rn(__fmul_rn(acc, DECAY), x);
}

template <int KIND>
__global__ void __launch_bounds__(LANES)
    extract_cost_kernel(const float* __restrict__ table, int rows,
                        const float* __restrict__ state0,
                        float* __restrict__ out, int steps) {
  __shared__ float red[LANES];
  __shared__ int row_idx;
  const int l = threadIdx.x;
  float st[SUB];
#pragma unroll
  for (int r = 0; r < SUB; ++r) st[r] = state0[r * LANES + l];
  if (l == 0) row_idx = 0;
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const float* row = table + (size_t)row_idx * ROW;
    if (KIND == VECTOR8) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int j = 0; j < 6; ++j) st[r] = fold(st[r], __ldg(row + 9 * r + j));
      }
    } else {
      constexpr int K = KIND == EXTRACT48 ? 48 : 6;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float x = __ldg(row + k);
#pragma unroll
        for (int r = 0; r < SUB; ++r) st[r] = fold(st[r], x);
      }
    }
    red[l] = st[0];
    __syncthreads();
#pragma unroll
    for (int h = LANES / 2; h > 0; h >>= 1) {
      if (l < h) red[l] = __fadd_rn(red[l], red[l + h]);
      __syncthreads();
    }
    if (l == 0) {
      const int nxt = ((int)red[0] + step) % rows;  // truncation, like astype
      row_idx = nxt < 0 ? nxt + rows : nxt;
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < SUB; ++r) out[r * LANES + l] = st[r];
}

}  // namespace

extern "C" int extract_cost_run(const float* table, int rows,
                                const float* state0, float* out, int steps,
                                int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == EXTRACT6) {
    extract_cost_kernel<EXTRACT6><<<1, LANES, 0, s>>>(table, rows, state0,
                                                      out, steps);
  } else if (kind == EXTRACT48) {
    extract_cost_kernel<EXTRACT48><<<1, LANES, 0, s>>>(table, rows, state0,
                                                       out, steps);
  } else if (kind == VECTOR8) {
    extract_cost_kernel<VECTOR8><<<1, LANES, 0, s>>>(table, rows, state0,
                                                     out, steps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* extract_cost_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
