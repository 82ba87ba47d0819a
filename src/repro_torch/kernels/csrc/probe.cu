// Rate probes for the two ways a packed-word kernel can count
// sum_w popcount(include & ~literal) on Hopper (sm_90a): the binary
// tensor-core product mma.sync m16n8k256 .b1 with AND-popcount, and a
// warp's __popc(a & ~b). No data sheet gives the H100's binary MMA rate,
// so chip_smoke.py's b1_probe phase measures both here and the packed
// kernels' bound takes the faster.
//
// Each block loops over independent operations (kChains accumulators a
// thread, operands in registers) between two clock64() reads, and
// stamps [t0, t1, smid, bit operations] into stamp[4 * block]. A bit
// operation is one AND-popcount of one bit pair: an m16n8k256 product
// does 16 x 8 x 256 of them, one __popc 32. The caller sums a
// multiprocessor's blocks over its own clock span, so the rate is in bit
// operations a clock an SM, independent of the clock the card ran at.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;  // independent accumulators a thread

__device__ __forceinline__ void mma_b1(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned sm_id() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;\n" : "=r"(s));
  return s;
}

__device__ __forceinline__ void stamp_block(long long* stamp, long long t0,
                                            long long t1, long long bits) {
  if (threadIdx.x == 0) {
    long long* s = stamp + 4 * blockIdx.x;
    s[0] = t0;
    s[1] = t1;
    s[2] = sm_id();
    s[3] = bits;
  }
}

__global__ void b1_mma_probe_kernel(const uint32_t* __restrict__ words,
                                    int iters, int32_t* __restrict__ sink,
                                    long long* __restrict__ stamp) {
  const int lane = threadIdx.x & 31;
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = words[(lane * 6 + i) & 255];
#pragma unroll
  for (int i = 0; i < 2; ++i) b[i] = words[(lane * 6 + 4 + i) & 255];
  int32_t acc[kChains][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) mma_b1(acc[c], a, b);
  }
  __syncthreads();
  const long long t1 = clock64();
  int32_t s = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
  stamp_block(stamp, t0, t1,
              static_cast<long long>(blockDim.x / 32) * iters * kChains *
                  16 * 8 * 256);
}

__global__ void popc_probe_kernel(const uint32_t* __restrict__ words,
                                  int iters, int32_t* __restrict__ sink,
                                  long long* __restrict__ stamp) {
  uint32_t a[kChains], b[kChains];
  unsigned v[kChains] = {};
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    a[c] = words[(threadIdx.x * 2 * kChains + 2 * c) & 255];
    b[c] = words[(threadIdx.x * 2 * kChains + 2 * c + 1) & 255];
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    // a[c] + it keeps the operand live in the loop, as a new word is in
    // the kernels: one add, one and-not and one accumulate a popcount
#pragma unroll
    for (int c = 0; c < kChains; ++c) v[c] += __popc((a[c] + it) & ~b[c]);
  }
  __syncthreads();
  const long long t1 = clock64();
  unsigned s = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += v[c];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<int32_t>(s);
  stamp_block(stamp, t0, t1,
              static_cast<long long>(blockDim.x) * iters * kChains * 32);
}

}  // namespace

// words: 256 uint32; sink: blocks * threads int32; stamp: blocks * 4
// int64. threads a multiple of 32.
extern "C" int b1_mma_probe(const void* words, int blocks, int threads,
                            int iters, void* sink, void* stamp,
                            void* stream) {
  b1_mma_probe_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), iters,
      static_cast<int32_t*>(sink), static_cast<long long*>(stamp));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int popc_probe(const void* words, int blocks, int threads,
                          int iters, void* sink, void* stamp, void* stream) {
  popc_probe_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), iters,
      static_cast<int32_t*>(sink), static_cast<long long*>(stamp));
  return static_cast<int>(cudaGetLastError());
}
