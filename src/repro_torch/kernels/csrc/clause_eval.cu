// Clause-plane counts for Hopper (sm_90a): the CUDA twins of the Pallas
// kernels clause_counts (K1), clause_counts_batch (K2), their
// replica-first forms clause_counts_replicated (K3) and
// clause_counts_batch_replicated (K4), and the bit-packed
// clause_counts_batch_packed (K5) and clause_counts_batch_replicated_packed
// (K6) in the reference package's kernels/clause_eval.py.
//
//   violations[r, cj, b] = sum_l include[r, cj, l] & ~literal[r % D, b, l]
//   n_included[r, cj]    = sum_l include[r, cj, l]
//
// Inputs are 1-byte bools: include [R, CJ, L], literals [D, B, L] with
// D | R; replica r reads data stream r % D, so a hyperparameter grid over
// one ordering shares its literal rows. Outputs are int32 violations
// [R, CJ, B] and n_included [R, CJ]. K1 and K2 are the R = D = 1 launches
// of the same kernels. All four are bound by memory traffic at the main
// path's shapes (they read the include planes once and do one add per
// byte), so none uses the tensor cores.
//
// K1/K3 (one datapoint per replica), bound by reading the include planes
// once (1.0 MB a bank at 640 x 1568: 0.30 us, below a launch's cost). The
// vector path (L % 16 == 0, both operands 16-byte aligned; iris L = 32,
// MNIST L = 1568) gives each clause row a group of G lanes, G the least
// power of two >= L / 16 up to a warp, so a warp counts 32 / G rows; a
// lane loads 16 include bytes and the 16 matching literal bytes at a time
// (uint4), two of each in flight before it counts (a warp covers 1024
// literals a round: two rounds at L = 1568). It counts on 32-bit words:
// nonzero_bytes marks each nonzero byte of a word with one bit (any
// nonzero byte, not only 1: the wrappers take uint8/int8 views), and
// __popc(inc & ~lit) and __popc(inc) add four literals a step. Blocks of
// four warps (160 blocks at 640 rows; times R with the replica axis), and
// __reduce_add_sync over a whole-warp group or a shuffle tree over a
// smaller one, finish both counts. The scalar path (any other
// width or alignment: L = 33, 513, 98, operands that are views with a
// storage offset) gives each row a warp whose lanes stride over L one
// byte at a time. The launcher picks the path from the width and the
// pointers.
//
// K2/K4 (a batch per replica): first the include planes of all R replicas
// and the literal batches of the D streams are packed once, 32 bools to a
// word, into scratch the wrapper allocates (one thread per word): the D
// batches are packed once, not R times. Then a block owns kRows = 64
// clause rows of one replica and kTB = 32 batch columns of its stream: it
// stages both word tiles in shared memory and lane t counts column t as
// sum_w popc(inc_w & ~lit_w). Each byte of the planes is read once; the
// words are re-read from L2 once per tile.
//
// K5/K6 (packed words): the caller's operands are already the packed
// planes, 32 literals a uint32 word in the two-half layout with include
// tail bits zero, so they go straight to K2/K4's counting kernel: no pack
// pass, and no n_included (the contract takes emptiness from the include
// words outside the kernel). The counting loop is __popc-bound here: at
// the serving shapes (640 rows x 1024 columns x 50 words) it issues 33 M
// popcounts against under 3 MB of operands and output.
//
// K7 (the pruned entries clause_eval_batch_pruned{,_replicated,_packed,
// _replicated_packed}): the reference gathers the include bank down to the
// M elected clauses of each class (an XLA gather to [R, C, M, L|W]) and
// then launches K2/K4/K5/K6 on the compacted bank. Here the gather folds
// into the row loads: a row map rowmap[(r, c, m)] = r*C*J + c*J +
// sel[r, c, m] names the row of the FULL bank that compacted row (r, c, m)
// reads. On packed words the counting kernel's include-tile staging loop
// reads through it; on bytes the pack pass packs only the R*C*M elected
// rows (M/J of the bank's bytes), and the counting kernel then runs over
// R x C*M rows with n_included on, exactly as K2/K4. A row id outside the
// bank stages an all-zero (empty) row, so no load leaves the bank; the
// wrappers reject such ids on the host before any launch. Bound: the
// __popc rate, as K5/K6, on C*M instead of C*J rows.
//
// Each C entry returns cudaGetLastError() so the caller sees a refused
// launch at once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // warps per block
constexpr int kCountWarps = 4;   // K1/K3 vector path: warps per block
constexpr int kRows = 64;        // K2: clause rows per block
constexpr int kTB = 32;          // K2: batch columns per block (one per lane)
constexpr unsigned kFull = 0xffffffffu;

__global__ void clause_counts_kernel(const uint8_t* __restrict__ inc,
                                     const uint8_t* __restrict__ lit,
                                     int32_t* __restrict__ viol,
                                     int32_t* __restrict__ ninc,
                                     int cj, int L, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= cj) return;  // whole warp leaves together
  const int r = blockIdx.y;
  const int64_t out = static_cast<int64_t>(r) * cj + row;
  const uint8_t* ir = inc + out * L;
  const uint8_t* lr = lit + static_cast<int64_t>(r % D) * L;
  unsigned v = 0, n = 0;
  for (int l = lane; l < L; l += 32) {
    const unsigned i = ir[l] != 0;
    n += i;
    v += i & (lr[l] == 0);
  }
  v = __reduce_add_sync(kFull, v);
  n = __reduce_add_sync(kFull, n);
  if (lane == 0) {
    viol[out] = static_cast<int32_t>(v);
    ninc[out] = static_cast<int32_t>(n);
  }
}

// Bit 7 of each byte of x set where that byte is nonzero, all else zero:
// (b & 0x7f) + 0x7f reaches bit 7 iff the low seven bits are not all zero,
// and no byte carries into the next (0x7f + 0x7f = 0xfe).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

// The vector path: row group of G = 1 << log_g lanes; 16-byte chunks.
__global__ void __launch_bounds__(kCountWarps * 32)
    clause_counts_vec_kernel(const uint8_t* __restrict__ inc,
                             const uint8_t* __restrict__ lit,
                             int32_t* __restrict__ viol,
                             int32_t* __restrict__ ninc, int cj, int L,
                             int D, int log_g) {
  constexpr int kInFlight = 2;  // chunks a lane loads before it counts
  const int G = 1 << log_g;
  const int lane = threadIdx.x & 31;
  const int warp_row = (blockIdx.x * kCountWarps + (threadIdx.x >> 5))
                       << (5 - log_g);
  if (warp_row >= cj) return;  // whole warp leaves together
  const int sub = lane & (G - 1);
  const int row = warp_row + (lane >> log_g);
  const bool live = row < cj;
  const int r = blockIdx.y;
  const int64_t out = static_cast<int64_t>(r) * cj + row;
  const uint4* ir = reinterpret_cast<const uint4*>(inc + out * L);
  const uint4* lr =
      reinterpret_cast<const uint4*>(lit + static_cast<int64_t>(r % D) * L);
  const int nchunk = L / 16;
  unsigned v = 0, n = 0;
  for (int c0 = sub; live && c0 < nchunk; c0 += kInFlight * G) {
    uint4 a[kInFlight], b[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int c = c0 + k * G;
      a[k] = c < nchunk ? __ldg(ir + c) : make_uint4(0, 0, 0, 0);
      b[k] = c < nchunk ? __ldg(lr + c) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const uint32_t iw[4] = {a[k].x, a[k].y, a[k].z, a[k].w};
      const uint32_t lw[4] = {b[k].x, b[k].y, b[k].z, b[k].w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t i = nonzero_bytes(iw[w]);
        n += __popc(i);
        v += __popc(i & ~nonzero_bytes(lw[w]));
      }
    }
  }
  if (G == 32) {
    v = __reduce_add_sync(kFull, v);
    n = __reduce_add_sync(kFull, n);
  } else {
    for (int off = G >> 1; off > 0; off >>= 1) {
      v += __shfl_xor_sync(kFull, v, off);
      n += __shfl_xor_sync(kFull, n, off);
    }
  }
  if (live && sub == 0) {
    viol[out] = static_cast<int32_t>(v);
    ninc[out] = static_cast<int32_t>(n);
  }
}

// Pack 32 one-byte bools per word, bit j of word w = element 32w + j; a
// tail past L packs zeros. One thread per word, so every load is in flight
// at once. With a row map, output row r packs source row rowmap[r] of the
// n_src rows (K7); a row id outside them packs zeros.
__global__ void pack_bits_kernel(const uint8_t* __restrict__ src,
                                 uint32_t* __restrict__ dst, int rows, int L,
                                 int nw, const int32_t* __restrict__ rowmap,
                                 int64_t n_src) {
  const int64_t n = static_cast<int64_t>(rows) * nw;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += step) {
    const int64_t r = i / nw;
    const int l0 = static_cast<int>(i - r * nw) * 32;
    const int64_t sr = rowmap != nullptr ? rowmap[r] : r;
    if (sr < 0 || sr >= n_src) {
      dst[i] = 0u;
      continue;
    }
    const uint8_t* p = src + sr * L + l0;
    uint32_t word = 0;
    if (l0 + 32 <= L) {
#pragma unroll
      for (int j = 0; j < 32; ++j) word |= static_cast<uint32_t>(p[j] != 0) << j;
    } else {
      for (int j = 0; l0 + j < L; ++j)
        word |= static_cast<uint32_t>(p[j] != 0) << j;
    }
    dst[i] = word;
  }
}

// Counts from packed words: a block of replica r = blockIdx.z stages its
// kRows include rows and kTB literal rows of stream r % D (contiguous in
// the packed arrays) in shared memory, then lane t of each warp counts
// column t for the warp's rows. A null ninc skips n_included (K5/K6/K7).
// Include row q of the block stages word row rowmap[row0 + q] of the
// n_src-row bank when kMapped (K7 on words; a row id outside the bank
// stages zeros), else row row0 + q. kMapped is a template argument so that
// the unmapped staging compiles without the map's load and bounds test.
template <bool kMapped>
__global__ void clause_counts_batch_kernel(const uint32_t* __restrict__ incw,
                                           const uint32_t* __restrict__ litw,
                                           int32_t* __restrict__ viol,
                                           int32_t* __restrict__ ninc,
                                           int cj, int B, int D, int nw,
                                           int stride,
                                           const int32_t* __restrict__ rowmap,
                                           int64_t n_src) {
  extern __shared__ uint32_t smem[];
  uint32_t* lit_s = smem;                   // [kTB][stride]
  uint32_t* inc_s = smem + kTB * stride;    // [kRows][stride]
  const int r = blockIdx.z;
  const int r0 = blockIdx.x * kRows;
  const int b0 = blockIdx.y * kTB;
  const int nr = min(kRows, cj - r0);
  const int nb = min(kTB, B - b0);
  const int64_t row0 = static_cast<int64_t>(r) * cj + r0;  // replica's rows
  const int64_t col0 = static_cast<int64_t>(r % D) * B + b0;
  for (int i = threadIdx.x; i < nb * nw; i += blockDim.x) {
    const int t = i / nw;
    lit_s[t * stride + (i - t * nw)] = litw[col0 * nw + i];
  }
  for (int i = threadIdx.x; i < nr * nw; i += blockDim.x) {
    const int q = i / nw;
    const int w = i - q * nw;
    const int64_t sr = kMapped ? rowmap[row0 + q] : row0 + q;
    // unmapped rows are contiguous, so word i of the tile is word
    // row0 * nw + i: cheaper than sr * nw + w (K5/K6 run ~4% faster)
    const int64_t at = kMapped ? sr * nw + w : row0 * nw + i;
    inc_s[q * stride + w] =
        kMapped && (sr < 0 || sr >= n_src) ? 0u : incw[at];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* lw = lit_s + lane * stride;
  for (int q = warp; q < nr; q += kWarps) {
    const uint32_t* iw = inc_s + q * stride;
    if (lane < nb) {
      unsigned v = 0;
      for (int w = 0; w < nw; ++w) v += __popc(iw[w] & ~lw[w]);
      viol[(row0 + q) * B + b0 + lane] = static_cast<int32_t>(v);
    }
    if (ninc != nullptr && blockIdx.y == 0) {
      unsigned n = 0;
      for (int w = lane; w < nw; w += 32) n += __popc(iw[w]);
      n = __reduce_add_sync(kFull, n);
      if (lane == 0) ninc[row0 + q] = static_cast<int32_t>(n);
    }
  }
}

}  // namespace

// K1 (R = D = 1) and K3: include [R, CJ, L], literals [D, L].
extern "C" int clause_counts_replicated(const void* inc, const void* lit,
                                        void* viol, void* ninc, int R, int D,
                                        int cj, int L, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* i8 = static_cast<const uint8_t*>(inc);
  const uint8_t* l8 = static_cast<const uint8_t*>(lit);
  int32_t* v32 = static_cast<int32_t*>(viol);
  int32_t* n32 = static_cast<int32_t*>(ninc);
  if (L % 16 == 0 && reinterpret_cast<uintptr_t>(inc) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(lit) % 16 == 0) {
    int log_g = 0;
    while (log_g < 5 && (1 << log_g) < L / 16) ++log_g;
    const int rows = kCountWarps << (5 - log_g);  // rows a block
    const dim3 grid((cj + rows - 1) / rows, R);
    clause_counts_vec_kernel<<<grid, kCountWarps * 32, 0, st>>>(
        i8, l8, v32, n32, cj, L, D, log_g);
  } else {
    const dim3 grid((cj + kWarps - 1) / kWarps, R);
    clause_counts_kernel<<<grid, kWarps * 32, 0, st>>>(i8, l8, v32, n32, cj,
                                                        L, D);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared memory the batch kernel needs for literal width L, in bytes.
extern "C" int clause_counts_batch_smem(int L) {
  const int nw = (L + 31) / 32;
  const int stride = nw | 1;  // odd word stride: lanes hit distinct banks
  return (kTB + kRows) * stride * 4;
}

namespace {

// Lift the batch kernel's dynamic shared-memory cap when a tile needs it.
int allow_smem(int smem) {
  if (smem <= 48 * 1024) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      clause_counts_batch_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(clause_counts_batch_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  return static_cast<int>(e);
}

// K2/K4 and K7 on bytes: pack the include rows (through rowmap when it is
// set: inc_rows compacted rows of the n_src-row bank) and the D literal
// batches, then count over R x cj rows with n_included.
int counts_batch_bytes(const void* inc, const int32_t* rowmap, int64_t n_src,
                       const void* lit, void* viol, void* ninc, void* scratch,
                       int R, int D, int cj, int L, int B, void* stream) {
  const int nw = (L + 31) / 32;
  const int stride = nw | 1;
  const int smem = clause_counts_batch_smem(L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = allow_smem(smem);
  if (e != 0) return e;
  const int inc_rows = R * cj;
  const int lit_rows = D * B;
  uint32_t* incw = static_cast<uint32_t*>(scratch);
  uint32_t* litw = incw + static_cast<int64_t>(inc_rows) * nw;
  const int64_t words = static_cast<int64_t>(inc_rows + lit_rows) * nw;
  const unsigned pack_blocks = static_cast<unsigned>(
      (words + 255) / 256 < 132 * 16 ? (words + 255) / 256 : 132 * 16);
  pack_bits_kernel<<<pack_blocks, 256, 0, st>>>(
      static_cast<const uint8_t*>(inc), incw, inc_rows, L, nw, rowmap,
      rowmap != nullptr ? n_src : inc_rows);
  pack_bits_kernel<<<pack_blocks, 256, 0, st>>>(
      static_cast<const uint8_t*>(lit), litw, lit_rows, L, nw, nullptr,
      lit_rows);
  const dim3 grid((cj + kRows - 1) / kRows, (B + kTB - 1) / kTB, R);
  clause_counts_batch_kernel<false><<<grid, kWarps * 32, smem, st>>>(
      incw, litw, static_cast<int32_t*>(viol), static_cast<int32_t*>(ninc),
      cj, B, D, nw, stride, nullptr, inc_rows);
  return static_cast<int>(cudaGetLastError());
}

// K5/K6 and K7 on words: count straight from the caller's words, include
// rows through rowmap when it is set.
int counts_batch_words(const void* incw, const int32_t* rowmap,
                       int64_t n_src, const void* litw, void* viol, int R,
                       int D, int cj, int W, int B, void* stream) {
  const int stride = W | 1;
  const int smem = clause_counts_batch_smem(32 * W);
  const int e = allow_smem(smem);
  if (e != 0) return e;
  const dim3 grid((cj + kRows - 1) / kRows, (B + kTB - 1) / kTB, R);
  const auto kernel = rowmap != nullptr ? clause_counts_batch_kernel<true>
                                        : clause_counts_batch_kernel<false>;
  kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(incw), static_cast<const uint32_t*>(litw),
      static_cast<int32_t*>(viol), nullptr, cj, B, D, W, stride, rowmap,
      n_src);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2 (R = D = 1) and K4: include [R, CJ, L], literals [D, B, L].
// scratch: (R * cj + D * B) * ceil(L / 32) uint32 words for the packed
// planes.
extern "C" int clause_counts_batch_replicated(
    const void* inc, const void* lit, void* viol, void* ninc, void* scratch,
    int R, int D, int cj, int L, int B, void* stream) {
  return counts_batch_bytes(inc, nullptr, 0, lit, viol, ninc, scratch, R, D,
                            cj, L, B, stream);
}

// K5 (R = D = 1) and K6: packed include words [R, CJ, W] and literal words
// [D, B, W] (uint32, the same word width W) -> violations [R, CJ, B].
// Shared memory: clause_counts_batch_smem(32 * W).
extern "C" int clause_counts_batch_packed_replicated(
    const void* incw, const void* litw, void* viol, int R, int D, int cj,
    int W, int B, void* stream) {
  return counts_batch_words(incw, nullptr, 0, litw, viol, R, D, cj, W, B,
                            stream);
}

// K7 on bytes (clause_eval_batch_pruned, R = D = 1, and
// clause_eval_batch_pruned_replicated): include bytes [n_src = R*C*J, L],
// rowmap [R * cm] int32 (cm = C * M compacted rows a replica), literals
// [D, B, L] -> violations [R, cm, B] and n_included [R, cm]. scratch:
// (R * cm + D * B) * ceil(L / 32) uint32 words.
extern "C" int clause_counts_batch_pruned_replicated(
    const void* inc, const void* rowmap, const void* lit, void* viol,
    void* ninc, void* scratch, int R, int D, int cm, int n_src, int L, int B,
    void* stream) {
  return counts_batch_bytes(inc, static_cast<const int32_t*>(rowmap), n_src,
                            lit, viol, ninc, scratch, R, D, cm, L, B, stream);
}

// K7 on words (clause_eval_batch_pruned_packed, R = D = 1, and
// clause_eval_batch_pruned_replicated_packed): include words [n_src, W],
// rowmap [R * cm], literal words [D, B, W] -> violations [R, cm, B].
extern "C" int clause_counts_batch_pruned_packed_replicated(
    const void* incw, const void* rowmap, const void* litw, void* viol, int R,
    int D, int cm, int n_src, int W, int B, void* stream) {
  return counts_batch_words(incw, static_cast<const int32_t*>(rowmap), n_src,
                            litw, viol, R, D, cm, W, B, stream);
}
