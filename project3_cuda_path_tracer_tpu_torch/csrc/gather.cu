// P1: a gather of 32-bit texels by index, out[i] = table[idx[i]].
//
// Replaces the Pallas probe kernel `kernel` of `dgather` in
// tools/exp_gather.py (jnp.take_along_axis on a lane-replicated [P, 128]
// u32 table, which lowers to tpu.dynamic_gather). The lane replication is
// how the TPU feeds its per-lane gather; the function computed is
// flat_table[idx]. Here the kernel takes the flat [P] table.
//
// What bounds it on this card: memory traffic. Each fetch reads a 4-byte
// index and writes a 4-byte texel, both coalesced; the table (64 KB or
// 256 KB for the probe's 128x128 and 256x256 atlases) stays in L1/L2, so
// the random reads hit cache and the stream of indices and outputs through
// device memory is the cost. One thread per index, read through the
// read-only path (__ldg). An index outside [0, P) reads 0 rather than
// memory outside the table (the plain version raises there).
//
// Interface (plain C, bound with ctypes by tools/exp_gather.py):
//   table [P] u32; idx [n] i32; out [n] u32. Returns cudaGetLastError()
//   after the launch.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    gather_kernel(const uint32_t* __restrict__ table, int table_size,
                  const int32_t* __restrict__ idx,
                  uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int32_t j = __ldg(idx + i);
  out[i] = (j >= 0 && j < table_size) ? __ldg(table + j) : 0u;
}

}  // namespace

extern "C" int gather_u32(const uint32_t* table, int table_size,
                          const int32_t* idx, uint32_t* out, long long n,
                          void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  gather_kernel<<<(unsigned)blocks, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(table, table_size,
                                                       idx, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
