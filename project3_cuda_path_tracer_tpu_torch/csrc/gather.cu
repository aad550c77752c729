// P1: a gather of 32-bit texels by index, out[i] = table[idx[i]].
//
// Replaces the Pallas probe kernel `kernel` of `dgather` in the JAX
// package's tools/exp_gather.py (jnp.take_along_axis on a lane-replicated
// [P, 128] u32 table, which lowers to tpu.dynamic_gather). The lane
// replication is how the TPU feeds its per-lane gather; the function
// computed is flat_table[idx]. Here the kernel takes the flat [P] table.
//
// What bounds it on this card: memory traffic. The call must read n 4-byte
// indices and write n 4-byte texels (32 MB for the probe's 4M fetches); the
// table is small beside that. What costs beyond it is the random table
// read: a 4-byte read that misses L1 moves a 32-byte L2 sector, so a table
// that outgrows L1 (256 KB, shared with shared memory) turns 4M reads into
// ~134 MB of L2 traffic. The design stages the table in shared memory
// where it fits:
//   - K = 1 (`block`): each block of a persistent grid stages the whole
//     table in its dynamic shared memory with 1-D TMA bulk copies
//     (cp.async.bulk, completed on an mbarrier) and reads it from there;
//   - K = 0 (`l2`): no staging, the table read through the read-only path
//     (__ldg).
// Every instance streams the indices in and the texels out 16 bytes a
// thread (int4 / uint4, evict-first), each thread keeping GROUPS groups in
// flight and as many requested ahead, one block of 1024 threads an SM. An
// index pointer that is not 16-byte aligned (a view at an offset) and the
// ragged tail (n not a multiple of 4) take scalar code. The index loads of the first groups are
// issued before the block waits for its table. An index outside [0, P)
// reads 0 (the plain version raises there).
//
// The wrapper (ops/texfetch.py) picks K from the table's size alone, before
// the launch: `block` while one block's shared memory holds the table, `l2`
// above. (Tables split across a thread block cluster and read through
// distributed shared memory lost to `l2` on an H100: PERF.md.)
// `gather_plan` sizes the persistent grid
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
//
// Interface (plain C, bound with ctypes by ops/texfetch.py):
//   gather_plan(k, table_size, out[2]) -> grid, and blocks per SM in out;
//   gather_launch(k, grid, table [P] u32, P, table_aligned, idx [n] i32,
//     out [n] u32, n, idx_aligned, stream).
// Both return a cudaError_t (cudaGetLastError() after the launch).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
// int4 index groups a thread stores per turn: four where the table is in
// shared memory, one where the table reads are random L2 reads (more of
// them in flight queue behind each other: measured on an H100).
template <int K>
constexpr int GROUPS = K == 0 ? 1 : 4;
// Bytes of table one block holds (ops/texfetch.SLICE_BYTES).
constexpr int SLICE_MAX = 200 * 1024;
constexpr uint32_t CHUNK_WORDS = 8192;  // 32 KB per bulk copy

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stage `words` words from `src` into `dst` (shared): thread 0 issues bulk
// copies for the 16-byte part when `bulk`, every thread copies the rest
// plainly. The bulk part has landed once `bar` completes phase 0.
__device__ void stage(const uint32_t* src, uint32_t words, bool bulk,
                      uint32_t* dst, uint64_t* bar) {
  const uint32_t bar_a = smem_addr(bar);
  const uint32_t bulk_words = bulk ? (words & ~3u) : 0u;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar_a),
        "r"(bulk_words * 4u)
        : "memory");
    for (uint32_t w = 0; w < bulk_words; w += CHUNK_WORDS) {
      const uint32_t len =
          (bulk_words - w < CHUNK_WORDS ? bulk_words - w : CHUNK_WORDS) * 4u;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst + w)),
          "l"(src + w), "r"(len), "r"(bar_a)
          : "memory");
    }
  }
  for (uint32_t w = bulk_words + threadIdx.x; w < words; w += THREADS)
    dst[w] = __ldg(src + w);
}

__device__ __forceinline__ void wait_phase0(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// The table as a K instance reads it.
template <int K>
struct Table {
  const uint32_t* g;  // K = 0
  const uint32_t* s;  // K = 1: this block's copy
  uint32_t size;

  __device__ __forceinline__ uint32_t operator()(int32_t j) const {
    const uint32_t u = static_cast<uint32_t>(j);
    if (u >= size) return 0u;
    return K == 0 ? __ldg(g + u) : s[u];
  }
};

template <int K>
__device__ __forceinline__ uint4 fetch4(const Table<K>& t, int4 j) {
  return make_uint4(t(j.x), t(j.y), t(j.z), t(j.w));
}

template <int K>
__global__ void __launch_bounds__(THREADS)
    gather_kernel(const uint32_t* __restrict__ table, uint32_t size,
                  int table_aligned, const int32_t* __restrict__ idx,
                  uint32_t* __restrict__ out, long long n, int idx_aligned,
                  unsigned long long* launches) {
  // The launch tally, or null (utils/launches.py).
  if (launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(launches, 1ull);
  extern __shared__ __align__(16) uint32_t tab_s[];
  __shared__ __align__(8) uint64_t bar;
  Table<K> t;
  t.g = table;
  t.s = tab_s;
  t.size = size;
  if (K == 1) stage(table, size, table_aligned != 0, tab_s, &bar);

  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long step = GROUPS<K> * stride;
  const long long n4 = idx_aligned ? n >> 2 : 0;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  uint4* out4 = reinterpret_cast<uint4*>(out);

  int4 cur[GROUPS<K>];
#pragma unroll
  for (int u = 0; u < GROUPS<K>; ++u) {
    const long long gi = tid + u * stride;
    cur[u] = gi < n4 ? __ldcs(idx4 + gi) : make_int4(0, 0, 0, 0);
  }
  if (K == 1) {
    wait_phase0(&bar);
    __syncthreads();  // the plainly copied tail words
  }

  for (long long g = tid; g < n4; g += step) {
    int4 nxt[GROUPS<K>];
#pragma unroll
    for (int u = 0; u < GROUPS<K>; ++u) {
      const long long gi = g + step + u * stride;
      nxt[u] = gi < n4 ? __ldcs(idx4 + gi) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < GROUPS<K>; ++u) {
      const long long gi = g + u * stride;
      if (gi < n4) __stcs(out4 + gi, fetch4(t, cur[u]));
      cur[u] = nxt[u];
    }
  }
  // The ragged tail, or every index when the pointer is not 16-byte
  // aligned.
  for (long long i = n4 * 4 + tid; i < n; i += stride)
    __stcs(out + i, t(__ldcs(idx + i)));
}

typedef void (*KernelFn)(const uint32_t*, uint32_t, int, const int32_t*,
                         uint32_t*, long long, int, unsigned long long*);

KernelFn kernel_for(int k) {
  switch (k) {
    case 0: return gather_kernel<0>;
    case 1: return gather_kernel<1>;
    default: return nullptr;
  }
}

// Shared-memory bytes of instance k: the table rounded up to 16 bytes for
// the bulk copy (K = 1), none for K = 0.
size_t smem_bytes(int k, uint32_t size) {
  return k == 0 ? 0 : size_t((size + 3u) & ~3u) * 4;
}

}  // namespace

extern "C" int gather_plan(int k, int table_size, int* out) {
  KernelFn fn = kernel_for(k);
  if (fn == nullptr || table_size <= 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(k, table_size);
  if (smem > SLICE_MAX) return cudaErrorInvalidValue;
  cudaError_t rc = cudaSuccess;
  if (k > 0 && (rc = cudaFuncSetAttribute(
                    fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                    SLICE_MAX)) != cudaSuccess)
    return rc;
  int dev = 0, sms = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return rc;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev)) != cudaSuccess)
    return rc;
  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                     smem);
  if (rc != cudaSuccess) return rc;
  // One block an SM: a second one measured slower on an H100 (a second
  // table copy to stage; more random reads in flight for K = 0).
  if (per_sm > 1) per_sm = 1;
  out[0] = per_sm * sms;
  out[1] = per_sm;
  return out[0] > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

extern "C" int gather_launch(int k, int grid, const uint32_t* table,
                             int table_size, int table_aligned,
                             const int32_t* idx, uint32_t* out, long long n,
                             int idx_aligned, unsigned long long* launches,
                             void* stream) {
  KernelFn fn = kernel_for(k);
  if (fn == nullptr || table_size <= 0 || grid <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(k, table_size);
  if (smem > SLICE_MAX) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  // No more blocks than the work needs.
  const long long units = idx_aligned ? (n >> 2) + (n & 3) : n;
  long long blocks = (units + THREADS - 1) / THREADS;
  if (blocks > grid) blocks = grid;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaError_t rc =
      cudaLaunchKernelEx(&cfg, fn, table, (uint32_t)table_size,
                         table_aligned, idx, out, n, idx_aligned, launches);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
