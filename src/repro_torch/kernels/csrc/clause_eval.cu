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
// of the same kernels. Any nonzero byte counts as 1 (the wrappers take
// bool, uint8 and int8 views), as the plain versions' .to(bool) does.
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
// K2/K4 (a batch per replica) and K7 on bytes: one launch of an int8
// tensor-core product, as the reference's MXU matmul. The operands are
// already K-major (include [rows, L] and literals [B, L], L contiguous),
// the .row.col layout of mma.sync m16n8k32, so neither is transposed:
//
//   viol[r, q, b] = sum_l nz(inc[row(r, q), l]) * (1 - nz(lit[r % D, b, l]))
//
// A block owns a square tile of clause rows x batch columns of one
// replica (blockIdx.z): 64 x 64 with four warps, or 128 x 128 with eight
// where the 64 x 64 grid would hold 8 or more blocks an SM (the R = 16
// serves). Each tile re-reads its rows whole from L2, and that traffic,
// at roughly 30 GB/s an SM on the H100, bounds these launches; larger
// tiles re-read less but leave SMs idle on small grids. A block walks L
// in 64-byte chunks through a ring of four shared-memory stages (80-byte
// rows: ldmatrix's eight row addresses fall in distinct banks), filled by
// 16-byte cp.async copies where L % 16 == 0 and both operands are 16-byte
// aligned (the main path: iris L = 32, MNIST L = 1568; zero-filled past L
// and for rows outside the problem), otherwise by byte loads, zero-filled
// the same way; the launcher picks the path from the width and the
// pointers. Each warp ldmatrix-loads the fragments of its 32 x 32 or
// 64 x 32 sub-tile and normalises them in registers with the SWAR byte
// tests below: include bytes become 0x80 where nonzero, literal bytes
// 0x01 where zero, so one u8 x u8 product with s32 accumulation counts
// 128 x the violations (exact for L < 2**24: the wrappers refuse wider).
// The blocks of the first batch tile also count n_included from the
// staged include tile (popcounts of the nonzero bytes). One launch, no
// scratch. Bound at the serve shape (640 x 1568 x 1024): 2.6 MB of
// operands and 2.6 MB of counts, 1.6 us at 3.35 TB/s; the 2.06 G int8
// operations take 1.0 us of tensor-core time.
//
// K5/K6 (packed words): the caller's operands are already the packed
// planes, 32 literals a uint32 word in the two-half layout with include
// tail bits zero, so a counting kernel reads them as they are: no pack
// pass, and no n_included (the contract takes emptiness from the include
// words outside the kernel). The counting loop is __popc-bound here: at
// the serving shapes (640 rows x 1024 columns x 50 words) it issues 33 M
// popcounts against under 3 MB of operands and output.
//
// K7 (the pruned entries clause_eval_batch_pruned{,_replicated,_packed,
// _replicated_packed}): the reference gathers the include bank down to the
// M elected clauses of each class (an XLA gather to [R, C, M, L|W]) and
// then launches K2/K4/K5/K6 on the compacted bank. Here the gather folds
// into the row loads. On bytes the tensor-core kernel reads sel [R, C, M]
// (int32 or int64, by template) itself: compacted row q = c*M + m of
// replica r stages bank row (r*C + c)*J + sel[r, c, m], one launch a
// call. On packed words a row map rowmap[(r, c, m)] = r*C*J + c*J +
// sel[r, c, m], built by the wrapper, names the row the counting kernel's
// include-tile staging loop reads. A row id outside the bank stages an
// all-zero (empty) row, so no load leaves the bank; the wrappers reject
// such ids on the host before any launch. Bound on bytes: the elected
// rows, the literals and the int32 counts over 3.35 TB/s; on words the
// __popc rate, as K5/K6, on C*M instead of C*J rows.
//
// Each C entry returns cudaGetLastError() so the caller sees a refused
// launch at once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // warps per block
constexpr int kCountWarps = 4;   // K1/K3 vector path: warps per block
constexpr int kRows = 64;        // K5/K6: clause rows per block
constexpr int kTB = 32;          // K5/K6: batch columns a block, one a lane
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

// ---- K2/K4 and K7 on bytes: the int8 tensor-core body ----

constexpr int kChunk = 64;             // literal bytes a stage
constexpr int kPitch = kChunk + 16;    // bytes a staged row (bank spread)
constexpr int kStages = 4;             // ring depth

// Bit 7 of each byte of x set where that byte is zero, all else zero.
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  return ~((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x)) & 0x80808080u;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; the bytes past ``bytes`` (all
// of them when it is 0) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 16-byte matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and d[i] is this lane's word of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 32 u8, row) x b (32 x 8 u8, col), s32 accumulate.
__device__ __forceinline__ void mma_u8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Violations (and, with ninc, n_included) of the cm rows of replica r =
// blockIdx.z against the B literal rows of stream r % D; one block per
// tile of kTile clause rows x kTile batch columns, 2 x kWarpsN warps
// (tile 64: 2 x 2 warps of 32 x 32; tile 128: 2 x 4 warps of 64 x 32).
// Row q of replica r reads bank row r*cm + q, or with sel (kSelBytes 4
// or 8: int32 or int64 ids [R, cm / M, M]) bank row (r*C + c)*J +
// sel[r*cm + q], q = c*M + m, C = cm / M; an id outside [0, J) stages
// zeros. kVec: 16-byte cp.async staging (L % 16 == 0, both operands
// 16-byte aligned); else byte loads. Shared memory: kStages x 2 x kTile x
// kPitch bytes.
template <int kTile, int kWarpsN, bool kVec, int kSelBytes>
__global__ void __launch_bounds__(2 * kWarpsN * 32)
    counts_batch_mma_kernel(const uint8_t* __restrict__ inc,
                            const void* __restrict__ sel,
                            const uint8_t* __restrict__ lit,
                            int32_t* __restrict__ viol,
                            int32_t* __restrict__ ninc, int cm, int M, int J,
                            int L, int B, int D) {
  constexpr int kThreads = 2 * kWarpsN * 32;
  constexpr int kMI = kTile / 2 / 16;        // m16 tiles a warp
  constexpr int kNI = kTile / kWarpsN / 8;   // n8 tiles a warp
  static_assert(2 * kTile == kThreads, "one row per 4 threads per stage");
  // [stage][A | B][row]: static at tile 64 (40 KB; the same body on
  // dynamic shared memory compiled to fewer registers and ran slower on
  // the H100), dynamic at tile 128 (80 KB)
  uint8_t* tile;
  if constexpr (kTile == 64) {
    __shared__ __align__(128) uint8_t fixed[kStages * 2 * 64 * kPitch];
    tile = fixed;
  } else {
    extern __shared__ __align__(128) uint8_t dynamic[];
    tile = dynamic;
  }
  const int tid = threadIdx.x;
  const int r = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int b0 = blockIdx.y * kTile;

  // This thread stages 16-byte segment ``seg`` of include rows q0 + srow
  // and q0 + srow + kTile / 2 and of the literal rows b0 + the same; a
  // null source stages zeros.
  const int srow = tid >> 2;
  const int seg = (tid & 3) * 16;
  const uint8_t* src[4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = q0 + srow + kTile / 2 * j;
    src[j] = nullptr;
    if (q < cm) {
      const int64_t at = static_cast<int64_t>(r) * cm + q;
      int64_t row = at;
      if (kSelBytes != 0) {
        const int c = q / M;
        const int64_t id =
            kSelBytes == 4 ? static_cast<const int32_t*>(sel)[at]
                           : static_cast<const int64_t*>(sel)[at];
        row = id >= 0 && id < J
                  ? (static_cast<int64_t>(r) * (cm / M) + c) * J + id
                  : -1;
      }
      if (row >= 0) src[j] = inc + row * L + seg;
    }
    const int b = b0 + srow + kTile / 2 * j;
    src[2 + j] = b < B
                     ? lit + (static_cast<int64_t>(r % D) * B + b) * L + seg
                     : nullptr;
  }
  auto stage = [&](int s, int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint8_t* dst = tile + ((2 * s + (j >> 1)) * kTile + srow +
                             kTile / 2 * (j & 1)) * kPitch + seg;
      const uint8_t* p = src[j];
      if (kVec) {
        const bool live = p != nullptr && k0 + seg < L;
        cp_async16(dst, live ? p + k0 : inc, live ? 16 : 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (p != nullptr) {
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (k0 + seg + i < L)
              w[i >> 2] |= static_cast<uint32_t>(p[k0 + i]) << (8 * (i & 3));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  const int nk = (L + kChunk - 1) / kChunk;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stage(s, s * kChunk);
    cp_async_commit();
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp & 1) * (kTile / 2);          // the warp's rows
  const int wn = (warp >> 1) * (kTile / kWarpsN);   // and its columns
  const bool count_inc = ninc != nullptr && blockIdx.y == 0;
  int32_t acc[kMI][kNI][4] = {};
  unsigned n_inc = 0;  // nonzero include bytes of row tid / 2, half tid % 2
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage k landed; stage k - 1 fully read
    const int next = k + kStages - 1;
    if (next < nk) stage(next % kStages, next * kChunk);
    cp_async_commit();
    const uint8_t* a_s = tile + 2 * (k % kStages) * kTile * kPitch;
    const uint8_t* b_s = a_s + kTile * kPitch;
    if (count_inc) {
      const uint4* p = reinterpret_cast<const uint4*>(
          a_s + (tid >> 1) * kPitch + (tid & 1) * 32);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint4 v = p[i];
        n_inc += __popc(nonzero_bytes(v.x)) + __popc(nonzero_bytes(v.y)) +
                 __popc(nonzero_bytes(v.z)) + __popc(nonzero_bytes(v.w));
      }
    }
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 32) {
      uint32_t a[kMI][4], b[kNI][2];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        ldmatrix_x4(a[mi], a_s + (wm + mi * 16 + (lane & 15)) * kPitch + kk +
                               (lane >> 4) * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[mi][i] = nonzero_bytes(a[mi][i]);
      }
#pragma unroll
      for (int nj = 0; nj < kNI / 2; ++nj) {
        uint32_t t[4];
        ldmatrix_x4(t, b_s + (wn + nj * 16 + (lane & 7) + (lane >> 4) * 8) *
                                 kPitch +
                           kk + (lane >> 3 & 1) * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) b[2 * nj + (i >> 1)][i & 1] =
            zero_bytes(t[i]) >> 7;
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) mma_u8(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();

  // acc holds 128 x the violations; fragment element (h, e) of tile
  // (mi, ni) is row g + 8h, column 2 * (lane % 4) + e.
  const int g = lane >> 2;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + wm + mi * 16 + g + 8 * h;
      if (q >= cm) continue;
      int32_t* out = viol + (static_cast<int64_t>(r) * cm + q) * B;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int b = b0 + wn + ni * 8 + 2 * (lane & 3);
        if (b < B) out[b] = acc[mi][ni][2 * h] >> 7;
        if (b + 1 < B) out[b + 1] = acc[mi][ni][2 * h + 1] >> 7;
      }
    }
  if (count_inc) {
    n_inc += __shfl_xor_sync(kFull, n_inc, 1);
    const int q = q0 + (tid >> 1);
    if ((tid & 1) == 0 && q < cm)
      ninc[static_cast<int64_t>(r) * cm + q] = static_cast<int32_t>(n_inc);
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

// One launch of the tensor-core body at tile kTile (kWarpsN warp columns)
// over R x cm rows, picking the staging path and the sel type.
template <int kTile, int kWarpsN>
int launch_mma(bool vec, const void* inc, const void* sel, int sel_bytes,
               const void* lit, void* viol, void* ninc, int R, int D, int cm,
               int M, int J, int L, int B, cudaStream_t st) {
  using Kernel = void (*)(const uint8_t*, const void*, const uint8_t*,
                          int32_t*, int32_t*, int, int, int, int, int, int);
  const Kernel kernels[2][3] = {
      {counts_batch_mma_kernel<kTile, kWarpsN, false, 0>,
       counts_batch_mma_kernel<kTile, kWarpsN, false, 4>,
       counts_batch_mma_kernel<kTile, kWarpsN, false, 8>},
      {counts_batch_mma_kernel<kTile, kWarpsN, true, 0>,
       counts_batch_mma_kernel<kTile, kWarpsN, true, 4>,
       counts_batch_mma_kernel<kTile, kWarpsN, true, 8>}};
  if (sel_bytes != 0 && sel_bytes != 4 && sel_bytes != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel = kernels[vec][sel_bytes / 4];
  const int smem = kTile == 64 ? 0 : kStages * 2 * kTile * kPitch;
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((cm + kTile - 1) / kTile, (B + kTile - 1) / kTile, R);
  kernel<<<grid, 2 * kWarpsN * 32, smem, st>>>(
      static_cast<const uint8_t*>(inc), sel, static_cast<const uint8_t*>(lit),
      static_cast<int32_t*>(viol), static_cast<int32_t*>(ninc), cm, M, J, L,
      B, D);
  return static_cast<int>(cudaGetLastError());
}

// K2/K4 and K7 on bytes: one launch of the tensor-core body over R x cm
// rows (through sel when it is set: sel_bytes 4 or 8) with n_included.
// 64 x 64 tiles, or 128 x 128 tiles where the 64 x 64 grid would give
// every SM kBigGrid blocks or more: larger tiles re-read fewer operand
// bytes from L2, which bounds these launches, but leave small grids with
// idle SMs.
int counts_batch_bytes(const void* inc, const void* sel, int sel_bytes,
                       const void* lit, void* viol, void* ninc, int R, int D,
                       int cm, int M, int J, int L, int B, void* stream) {
  constexpr int64_t kBigGrid = 8;
  const bool vec = L % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(inc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(lit) % 16 == 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks64 =
      static_cast<int64_t>((cm + 63) / 64) * ((B + 63) / 64) * R;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return blocks64 >= kBigGrid * sms
             ? launch_mma<128, 4>(vec, inc, sel, sel_bytes, lit, viol, ninc,
                                  R, D, cm, M, J, L, B, st)
             : launch_mma<64, 2>(vec, inc, sel, sel_bytes, lit, viol, ninc, R,
                                 D, cm, M, J, L, B, st);
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

// K2 (R = D = 1) and K4: include [R, CJ, L], literals [D, B, L] ->
// violations [R, CJ, B] and n_included [R, CJ]. One launch, no scratch.
extern "C" int clause_counts_batch_replicated(const void* inc,
                                              const void* lit, void* viol,
                                              void* ninc, int R, int D,
                                              int cj, int L, int B,
                                              void* stream) {
  return counts_batch_bytes(inc, nullptr, 0, lit, viol, ninc, R, D, cj, cj,
                            0, L, B, stream);
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
// clause_eval_batch_pruned_replicated): include bytes [R, C, J, L], sel
// [R, C, M] (int32 when sel_bytes is 4, int64 when 8), literals
// [D, B, L] -> violations [R, C*M, B] and n_included [R, C*M]. One launch,
// no scratch.
extern "C" int clause_counts_batch_pruned_replicated(
    const void* inc, const void* sel, const void* lit, void* viol,
    void* ninc, int sel_bytes, int R, int D, int C, int M, int J, int L,
    int B, void* stream) {
  return counts_batch_bytes(inc, sel, sel_bytes, lit, viol, ninc, R, D,
                            C * M, M, J, L, B, stream);
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
