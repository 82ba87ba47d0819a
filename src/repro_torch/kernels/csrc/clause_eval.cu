// Clause-plane counts for Hopper (sm_90a): the CUDA twins of the Pallas
// kernels clause_counts (K1), clause_counts_batch (K2), their
// replica-first forms clause_counts_replicated (K3) and
// clause_counts_batch_replicated (K4), the bit-packed
// clause_counts_batch_packed (K5) and clause_counts_batch_replicated_packed
// (K6), and the four pruned entries that reuse them (K7), in the reference
// package's kernels/clause_eval.py.
//
//   violations[r, cj, b] = sum_l include[r, cj, l] & ~literal[r % D, b, l]
//   n_included[r, cj]    = sum_l include[r, cj, l]
//
// K1-K4 take 1-byte bools: include [R, CJ, L], literals [D, B, L] with
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
// K2/K4 (a batch per replica), K5/K6 (the same on packed words) and K7
// (the pruned entries) are one tensor-core body, templated on the operand
// kind: one launch a call, no pack pass, no scratch. The operands are
// already K-major (include [rows, L | W] and literals [B, L | W], the
// width contiguous), the .row.col layout of mma.sync, so neither is
// transposed:
//
//   bytes: viol[r, q, b] = sum_l nz(inc[row(r, q), l])
//                                * (1 - nz(lit[r % D, b, l]))
//   words: viol[r, q, b] = sum_w popcount(inc[row(r, q), w]
//                                         & ~lit[r % D, b, w])
//
// A block owns a square tile of clause rows x batch columns of one
// replica (blockIdx.z): 64 x 64 with four warps, or 128 x 128 with eight
// where the 64 x 64 grid would hold 8 or more blocks an SM (the R = 16
// serves). A block walks the row in 64-byte chunks (64 literals, or 16
// words: 512 literals) through a ring of four shared-memory stages
// (80-byte rows: ldmatrix's eight row addresses fall in distinct banks),
// zero-filled past the row and for rows outside the problem. Each warp
// ldmatrix-loads the fragments of its 32 x 32 or 64 x 32 sub-tile, 32
// bytes a step. An m16n8k256 .b1 fragment has the byte layout of an
// m16n8k32 .u8 one (a 32-bit register holds 4 bytes or 32 bits), so the
// two kinds share the addressing and differ only in registers:
//   - bytes: include bytes become 0x80 where nonzero, literal bytes 0x01
//     where zero (the SWAR byte tests below; any nonzero byte counts as
//     1), and one m16n8k32 u8 x u8 product with s32 accumulation counts
//     128 x the violations (exact for L < 2**24: the wrappers refuse
//     wider). The blocks of the first batch tile also count n_included
//     from the staged include tile (popcounts of the nonzero bytes).
//   - words: the include words as they are against the complemented
//     literal words, one m16n8k256 .b1 AND-popcount product: the sums
//     are the violations. A zero include word (past W, or a row outside
//     the problem) ANDs to 0 whatever the complemented pad holds, so any
//     bits within W count, tail bits included. No n_included (the
//     contract takes emptiness from the include words outside the
//     kernel).
// The ring is filled by cp.async copies, the widest the row length and
// both pointers allow: 16 bytes (bytes: L % 16 == 0, the main path's
// iris L = 32 and MNIST L = 1568; words: W % 4 == 0), on words 8 bytes
// (W % 2 == 0: every packed layout, W = 2 ceil(f / 32); at f = 784 the
// 200-byte rows start off 16-byte boundaries every other row), then 4;
// bytes off the 16-byte path take byte loads. The launcher picks from the
// width and the pointers. Even batches store column pairs as int2.
//
// What bounds it on the H100: on bytes, each tile re-reads its rows whole
// from L2 (200 KB a 64 x 64 tile at L = 1568), at roughly 30 GB/s an SM,
// above the HBM bound (2.6 MB of operands and 2.6 MB of counts at the
// serve shape 640 x 1568 x 1024: 1.6 us at 3.35 TB/s). On words the
// rows are 8x shorter and the int32 counts dominate the bytes (2.6 MB at
// 640 x 1024, 0.8 us): the b1 product runs about 21,700 bit operations a
// clock an SM, 44x a warp's __popc (chip_smoke.py's b1_probe phase on an
// H100 80GB HBM3), so the 1.05 G bit operations of that shape take 0.2
// us. Larger tiles re-read less but leave SMs idle on small grids.
//
// K7 (the pruned entries clause_eval_batch_pruned{,_replicated,_packed,
// _replicated_packed}): the reference gathers the include bank down to the
// M elected clauses of each class (an XLA gather to [R, C, M, L|W]) and
// then launches K2/K4/K5/K6 on the compacted bank. Here the gather folds
// into the row loads: the body reads sel [R, C, M] (int32 or int64, by
// template) itself, and compacted row q = c*M + m of replica r stages
// bank row (r*C + c)*J + sel[r, c, m]. A row id outside [0, J) stages an
// all-zero (empty) row, so no load leaves the bank; the wrappers reject
// such ids on the host before any launch. Bound: the elected rows, the
// ids, the literals and the int32 counts over 3.35 TB/s.
//
// Each C entry returns cudaGetLastError() so the caller sees a refused
// launch at once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // warps per block
constexpr int kCountWarps = 4;   // K1/K3 vector path: warps per block
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

// ---- K2/K4, K5/K6 and K7: the tensor-core batch body ----

constexpr int kChunk = 64;             // operand bytes a stage
constexpr int kPitch = kChunk + 16;    // bytes a staged row (bank spread)
constexpr int kStages = 4;             // ring depth

// Bit 7 of each byte of x set where that byte is zero, all else zero.
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  return ~((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x)) & 0x80808080u;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// N (4, 8 or 16) bytes global -> shared; the bytes past ``bytes`` (all of
// them when it is 0) are zero-filled. 16-byte copies bypass L1.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(N), "r"(bytes));
  }
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

// c += popcount(a (16 x 256 bits, row) AND b (256 x 8 bits, col)).
__device__ __forceinline__ void mma_b1(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Violations (and, on bytes with ninc, n_included) of the cm rows of
// replica r = blockIdx.z against the B literal rows of stream r % D; one
// block per tile of kTile clause rows x kTile batch columns, 2 x kWarpsN
// warps (tile 64: 2 x 2 warps of 32 x 32; tile 128: 2 x 4 warps of
// 64 x 32). A row is row_bytes bytes: L bytes, or W words (4 W bytes)
// when kWords. Row q of replica r reads bank row r*cm + q, or with sel
// (kSelBytes 4 or 8: int32 or int64 ids [R, cm / M, M]) bank row
// (r*C + c)*J + sel[r*cm + q], q = c*M + m, C = cm / M; an id outside
// [0, J) stages zeros. kCopy: the cp.async size (16, or on words 8 or 4;
// row_bytes a multiple of it and both operands aligned to it), or 0 for
// byte loads (bytes only). Shared memory: kStages x 2 x kTile x kPitch
// bytes.
template <int kTile, int kWarpsN, bool kWords, int kCopy, int kSelBytes>
__global__ void __launch_bounds__(2 * kWarpsN * 32)
    counts_batch_mma_kernel(const uint8_t* __restrict__ inc,
                            const void* __restrict__ sel,
                            const uint8_t* __restrict__ lit,
                            int32_t* __restrict__ viol,
                            int32_t* __restrict__ ninc, int cm, int M, int J,
                            int row_bytes, int B, int D) {
  constexpr int kThreads = 2 * kWarpsN * 32;
  constexpr int kMI = kTile / 2 / 16;        // m16 tiles a warp
  constexpr int kNI = kTile / kWarpsN / 8;   // n8 tiles a warp
  static_assert(2 * kTile == kThreads, "one row per 4 threads per stage");
  static_assert(kWords ? (kCopy == 4 || kCopy == 8 || kCopy == 16)
                       : (kCopy == 0 || kCopy == 16), "copy size");
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
      if (row >= 0) src[j] = inc + row * row_bytes + seg;
    }
    const int b = b0 + srow + kTile / 2 * j;
    src[2 + j] =
        b < B ? lit + (static_cast<int64_t>(r % D) * B + b) * row_bytes + seg
              : nullptr;
  }
  auto stage = [&](int s, int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint8_t* dst = tile + ((2 * s + (j >> 1)) * kTile + srow +
                             kTile / 2 * (j & 1)) * kPitch + seg;
      const uint8_t* p = src[j];
      if constexpr (kCopy != 0) {
#pragma unroll
        for (int i = 0; i < 16; i += kCopy) {
          const bool live = p != nullptr && k0 + seg + i < row_bytes;
          cp_async<kCopy>(dst + i, live ? p + k0 + i : inc,
                          live ? kCopy : 0);
        }
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (p != nullptr) {
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (k0 + seg + i < row_bytes)
              w[i >> 2] |= static_cast<uint32_t>(p[k0 + i]) << (8 * (i & 3));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  const int nk = (row_bytes + kChunk - 1) / kChunk;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stage(s, s * kChunk);
    cp_async_commit();
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp & 1) * (kTile / 2);          // the warp's rows
  const int wn = (warp >> 1) * (kTile / kWarpsN);   // and its columns
  const bool count_inc = !kWords && ninc != nullptr && blockIdx.y == 0;
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
      // 32 bytes a step: k = 32 bytes (u8) or k = 256 bits (b1), one
      // fragment layout. A step wholly past the row is all zeros: words
      // skip it (the last step of every W = 50 row); on bytes the test
      // made four of the five main-path launches 1-11% slower (H100,
      // L = 1568)
      if (kWords && k * kChunk + kk >= row_bytes) break;
      uint32_t a[kMI][4], b[kNI][2];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        ldmatrix_x4(a[mi], a_s + (wm + mi * 16 + (lane & 15)) * kPitch + kk +
                               (lane >> 4) * 16);
        if constexpr (!kWords) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[mi][i] = nonzero_bytes(a[mi][i]);
        }
      }
#pragma unroll
      for (int nj = 0; nj < kNI / 2; ++nj) {
        uint32_t t[4];
        ldmatrix_x4(t, b_s + (wn + nj * 16 + (lane & 7) + (lane >> 4) * 8) *
                                 kPitch +
                           kk + (lane >> 3 & 1) * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          b[2 * nj + (i >> 1)][i & 1] =
              kWords ? ~t[i] : zero_bytes(t[i]) >> 7;
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          if constexpr (kWords) {
            mma_b1(acc[mi][ni], a[mi], b[ni]);
          } else {
            mma_u8(acc[mi][ni], a[mi], b[ni]);
          }
        }
    }
  }
  cp_async_wait<0>();

  // acc holds the violations (words) or 128 x them (bytes); fragment
  // element (h, e) of tile (mi, ni) is row g + 8h, column 2 * (lane % 4)
  // + e. An even B keeps every column pair 8-byte aligned: one int2 store.
  constexpr int kShift = kWords ? 0 : 7;
  const int g = lane >> 2;
  const bool pairs = (B & 1) == 0;
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
        const int32_t v0 = acc[mi][ni][2 * h] >> kShift;
        const int32_t v1 = acc[mi][ni][2 * h + 1] >> kShift;
        if (pairs && b < B) {
          *reinterpret_cast<int2*>(out + b) = make_int2(v0, v1);
        } else {
          if (b < B) out[b] = v0;
          if (b + 1 < B) out[b + 1] = v1;
        }
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

namespace {

using Kernel = void (*)(const uint8_t*, const void*, const uint8_t*,
                        int32_t*, int32_t*, int, int, int, int, int, int);

template <int kTile, int kWarpsN, bool kWords, int kCopy>
Kernel pick_sel(int sel_bytes) {
  switch (sel_bytes) {
    case 0:
      return counts_batch_mma_kernel<kTile, kWarpsN, kWords, kCopy, 0>;
    case 4:
      return counts_batch_mma_kernel<kTile, kWarpsN, kWords, kCopy, 4>;
    case 8:
      return counts_batch_mma_kernel<kTile, kWarpsN, kWords, kCopy, 8>;
  }
  return nullptr;
}

// The body for a copy size (bytes: 16 or 0, byte loads; words: 16, 8 or
// 4) and a sel type (sel_bytes 0, 4 or 8); null for any other.
template <int kTile, int kWarpsN, bool kWords>
Kernel pick(int copy, int sel_bytes) {
  switch (copy) {
    case 16:
      return pick_sel<kTile, kWarpsN, kWords, 16>(sel_bytes);
    case 8:
      if constexpr (kWords) return pick_sel<kTile, kWarpsN, true, 8>(sel_bytes);
      break;
    case 4:
      if constexpr (kWords) return pick_sel<kTile, kWarpsN, true, 4>(sel_bytes);
      break;
    case 0:
      if constexpr (!kWords)
        return pick_sel<kTile, kWarpsN, false, 0>(sel_bytes);
      break;
  }
  return nullptr;
}

// One launch of the tensor-core body at tile kTile (kWarpsN warp columns)
// over R x cm rows.
template <int kTile, int kWarpsN, bool kWords>
int launch_mma(int copy, const void* inc, const void* sel, int sel_bytes,
               const void* lit, void* viol, void* ninc, int R, int D, int cm,
               int M, int J, int row_bytes, int B, cudaStream_t st) {
  const Kernel kernel = pick<kTile, kWarpsN, kWords>(copy, sel_bytes);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kTile == 64 ? 0 : kStages * 2 * kTile * kPitch;
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((cm + kTile - 1) / kTile, (B + kTile - 1) / kTile, R);
  kernel<<<grid, 2 * kWarpsN * 32, smem, st>>>(
      static_cast<const uint8_t*>(inc), sel, static_cast<const uint8_t*>(lit),
      static_cast<int32_t*>(viol), static_cast<int32_t*>(ninc), cm, M, J,
      row_bytes, B, D);
  return static_cast<int>(cudaGetLastError());
}

// The widest copy the rows and both operands allow: 16 bytes where the
// row length and both pointers are multiples of 16; on words 8, then 4
// (every int32 operand); on bytes otherwise 0, byte loads.
int copy_size(bool words, int row_bytes, const void* inc, const void* lit) {
  const uintptr_t at =
      reinterpret_cast<uintptr_t>(inc) | reinterpret_cast<uintptr_t>(lit);
  for (const int n : {16, 8, 4}) {
    if (!words && n < 16) break;
    if (row_bytes % n == 0 && at % n == 0) return n;
  }
  return words ? -1 : 0;
}

// One launch of the tensor-core body over R x cm rows of row_bytes bytes
// (through sel when it is set: sel_bytes 4 or 8), with n_included on
// bytes when ninc is set. 64 x 64 tiles, or 128 x 128 tiles where the
// 64 x 64 grid would give every SM kBigGrid blocks or more: larger tiles
// re-read fewer operand bytes from L2, which bounds the byte launches, but
// leave small grids with idle SMs. On words the same threshold picks the
// faster tile at every main-path shape (H100: 128 x 128 tiles take 29%
// less time on the R = 16, M = 128 pruned serve, 5,120 64 x 64 blocks,
// and as long or up to 47% longer on the 80-480-block K5, K6 and K = 1
// pruned grids).
template <bool kWords>
int counts_batch(const void* inc, const void* sel, int sel_bytes,
                 const void* lit, void* viol, void* ninc, int R, int D,
                 int cm, int M, int J, int row_bytes, int B, void* stream) {
  constexpr int64_t kBigGrid = 8;
  const int copy = copy_size(kWords, row_bytes, inc, lit);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks64 =
      static_cast<int64_t>((cm + 63) / 64) * ((B + 63) / 64) * R;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return blocks64 >= kBigGrid * sms
             ? launch_mma<128, 4, kWords>(copy, inc, sel, sel_bytes, lit,
                                          viol, ninc, R, D, cm, M, J,
                                          row_bytes, B, st)
             : launch_mma<64, 2, kWords>(copy, inc, sel, sel_bytes, lit,
                                         viol, ninc, R, D, cm, M, J,
                                         row_bytes, B, st);
}

}  // namespace

// K2 (R = D = 1) and K4: include [R, CJ, L], literals [D, B, L] ->
// violations [R, CJ, B] and n_included [R, CJ]. One launch, no scratch.
extern "C" int clause_counts_batch_replicated(const void* inc,
                                              const void* lit, void* viol,
                                              void* ninc, int R, int D,
                                              int cj, int L, int B,
                                              void* stream) {
  return counts_batch<false>(inc, nullptr, 0, lit, viol, ninc, R, D, cj, cj,
                             0, L, B, stream);
}

// K5 (R = D = 1) and K6: packed include words [R, CJ, W] and literal words
// [D, B, W] (uint32, the same word width W) -> violations [R, CJ, B]. One
// launch, no scratch.
extern "C" int clause_counts_batch_packed_replicated(
    const void* incw, const void* litw, void* viol, int R, int D, int cj,
    int W, int B, void* stream) {
  return counts_batch<true>(incw, nullptr, 0, litw, viol, nullptr, R, D, cj,
                            cj, 0, 4 * W, B, stream);
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
  return counts_batch<false>(inc, sel, sel_bytes, lit, viol, ninc, R, D,
                             C * M, M, J, L, B, stream);
}

// K7 on words (clause_eval_batch_pruned_packed, R = D = 1, and
// clause_eval_batch_pruned_replicated_packed): include words
// [R, C, J, W], sel [R, C, M] (int32 when sel_bytes is 4, int64 when 8),
// literal words [D, B, W] -> violations [R, C*M, B]. One launch, no
// scratch.
extern "C" int clause_counts_batch_pruned_packed_replicated(
    const void* incw, const void* sel, const void* litw, void* viol,
    int sel_bytes, int R, int D, int C, int M, int J, int W, int B,
    void* stream) {
  return counts_batch<true>(incw, sel, sel_bytes, litw, viol, nullptr, R, D,
                            C * M, M, J, 4 * W, B, stream);
}
