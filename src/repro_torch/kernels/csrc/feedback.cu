// Fused Type I/II TA-bank update for Hopper (sm_90a): the CUDA twin of the
// Pallas kernels feedback_plane (K8) and feedback_plane_replicated (K9) in
// the reference package's kernels/feedback.py.
//
// One elementwise pass over R flattened [CJ, L] banks, templated on the
// int8 and int16 TA types. Per-row control is three 1-byte bool planes
// [R, CJ] (clause output, Type I, Type II). Literals [D, L] and the
// uniforms u [D, CJ, L] are per data stream: replica r reads row r % D, so
// replicas that share an ordering share its draws. u is read from memory,
// because it comes from the port's threefry and that keeps the result
// bitwise the reference's. p_strengthen and p_erase are per replica: K9
// reads them from two [R] float32 device arrays, K8 (R = D = 1) passes
// them by value.
//
//   include = ta > N
//   d1 = (clause & lit) ? (u < p_strengthen) : -(u < p_erase)
//   d2 = clause & ~lit & ~include
//   ta' = clip(ta + (type1 ? d1 : 0) + (type2 ? d2 : 0), 1, 2N)
//
// Bound: memory. Each TA is read and written once, and u (4 bytes a TA,
// once per stream) is the widest operand; about ten integer operations a
// TA, so no tensor cores. At the f = 784 engine's step (R = D = 8,
// 640 x 1568, int8) the pass moves 48 MB: 14.4 us at 3.35 TB/s.
//
// Vector path (L % 16 == 0 and every operand 16-byte aligned; iris L = 32
// and MNIST L = 1568): a thread owns 16 consecutive literals of one clause
// row of one replica. It issues every load before any arithmetic: one
// 16-byte TA load (two for int16), four 16-byte u loads, one 16-byte
// literal load and the row's three control bytes, so 80 bytes or more a
// thread are in flight with few registers; then it updates the 16 TAs in
// registers and makes one 16-byte store (two for int16). A row with no
// feedback to apply is only clipped, which skips the float compares: the
// body is close to bound by its instruction issue, not only its bytes.
// Blocks of replicas that read the same u row (r % D == d) are adjacent
// in the grid (x = tile * H + h, y = d), so when D < R the second and
// later reads of a u tile hit L2; when D == R, u is read with the
// streaming hint (__ldcs). Walking several rows or replicas a thread, to
// load the literals once for all of them, needed more registers and ran
// slower at every measured shape.
//
// Scalar path (any other width or alignment: L = 33, 513, 98, narrow
// planes, operands that are views with a storage offset): one thread per
// element on a (literal block, clause row, replica) grid. The launcher
// picks the path from the shapes and pointers, never from a failure; both
// compute the same per-TA update bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 16;       // literals a thread owns on the vector path
constexpr int kThreads = 128;  // threads a block on the vector path

// One TA. d1 compares u once, against the threshold of its branch:
// (c & lit) ? u < p_strengthen : u < p_erase.
__device__ __forceinline__ int update(int s, bool li, float x, bool c,
                                      bool t1, bool t2, float ps, float pe,
                                      int n_states) {
  const bool cl = c && li;
  const int d1 = x < (cl ? ps : pe) ? (cl ? 1 : -1) : 0;
  const int d2 = static_cast<int>(c && !li && s <= n_states);
  return min(max(s + (t1 ? d1 : 0) + (t2 ? d2 : 0), 1), 2 * n_states);
}

template <typename T>
__global__ void feedback_plane_kernel(T* __restrict__ out,
                                      const T* __restrict__ ta,
                                      const uint8_t* __restrict__ lit,
                                      const uint8_t* __restrict__ c_out,
                                      const uint8_t* __restrict__ t1,
                                      const uint8_t* __restrict__ t2,
                                      const float* __restrict__ u,
                                      const float* __restrict__ ps_r,
                                      const float* __restrict__ pe_r,
                                      float ps_v, float pe_v, int cj, int L,
                                      int D, int n_states) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int r = blockIdx.z;
  const int d = r % D;
  const float p_strengthen = ps_r != nullptr ? ps_r[r] : ps_v;
  const float p_erase = pe_r != nullptr ? pe_r[r] : pe_v;
  const bool li = lit[static_cast<int64_t>(d) * L + l] != 0;
  const int64_t rows_r = static_cast<int64_t>(r) * cj;  // replica's rows
  const int64_t rows_d = static_cast<int64_t>(d) * cj;  // stream's u rows
  for (int row = blockIdx.y; row < cj; row += gridDim.y) {
    const int64_t q = rows_r + row;
    const int64_t i = q * L + l;
    out[i] = static_cast<T>(update(
        static_cast<int>(ta[i]), li, u[(rows_d + row) * L + l], c_out[q] != 0,
        t1[q] != 0, t2[q] != 0, p_strengthen, p_erase, n_states));
  }
}

// 16 TAs of type T in 32-bit words: element e is word e / kPer, slot
// e % kPer (little end first), sign-extended to int.
template <typename T>
struct Lanes {
  static constexpr int kPer = 4 / sizeof(T);     // TAs a word
  static constexpr int kWords = kVec / kPer;     // words of 16 TAs
  static constexpr int kBits = 8 * sizeof(T);

  __device__ static __forceinline__ int get(const uint32_t (&w)[kWords],
                                            int e) {
    const int up = 32 - kBits * (e % kPer + 1);  // slot to the top
    return static_cast<int>(w[e / kPer] << up) >> (32 - kBits);
  }
  // Word k of the 16 results (low bits of each int).
  __device__ static __forceinline__ uint32_t put(const int (&v)[kVec],
                                                 int k) {
    if constexpr (kPer == 4)
      return __byte_perm(__byte_perm(v[4 * k], v[4 * k + 1], 0x0040),
                         __byte_perm(v[4 * k + 2], v[4 * k + 3], 0x0040),
                         0x5410);
    return __byte_perm(v[2 * k], v[2 * k + 1], 0x5410);
  }
};

// One row's 16 TAs. A row with no Type I feedback, and no Type II feedback
// on a firing clause, has a zero delta and is only clipped; testing c in
// that condition also keeps the clause byte's load ahead of the branch.
template <typename T>
__device__ __forceinline__ void update16(uint32_t (&s)[Lanes<T>::kWords],
                                         const float (&x)[kVec],
                                         const uint32_t (&lits)[4], bool c,
                                         bool t1, bool t2, float ps,
                                         float pe, int n_states) {
  int v[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = Lanes<T>::get(s, e);
  if (t1 || (t2 && c)) {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      v[e] = update(v[e], ((lits[e / 4] >> (8 * (e % 4))) & 0xffu) != 0,
                    x[e], c, t1, t2, ps, pe, n_states);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = min(max(v[e], 1), 2 * n_states);
  }
#pragma unroll
  for (int k = 0; k < Lanes<T>::kWords; ++k) s[k] = Lanes<T>::put(v, k);
}

// The vector path: thread g of replica r = h * D + d (block x = tile * H
// + h, y = d) owns literals [16 c, 16 c + 16) of clause row `row`, where
// g = row * nchunk + c.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    feedback_plane_vec_kernel(T* __restrict__ out, const T* __restrict__ ta,
                              const uint8_t* __restrict__ lit,
                              const uint8_t* __restrict__ c_out,
                              const uint8_t* __restrict__ t1,
                              const uint8_t* __restrict__ t2,
                              const float* __restrict__ u,
                              const float* __restrict__ ps_r,
                              const float* __restrict__ pe_r, float ps_v,
                              float pe_v, int cj, int L, int D, int H,
                              int n_states) {
  constexpr int kWords = Lanes<T>::kWords;
  const int h = blockIdx.x % H;
  const int g = (blockIdx.x / H) * kThreads + threadIdx.x;
  const int nchunk = L / kVec;
  if (g >= cj * nchunk) return;
  const int d = blockIdx.y;
  const int r = h * D + d;
  const int row = g / nchunk;
  const int l0 = (g - row * nchunk) * kVec;
  const int64_t q = static_cast<int64_t>(r) * cj + row;

  // Every load first: the TA and u words, the literals, the row's control.
  const uint4* tp = reinterpret_cast<const uint4*>(ta + q * L + l0);
  uint32_t s[kWords];
#pragma unroll
  for (int k = 0; k < kWords / 4; ++k) {
    const uint4 w = __ldg(tp + k);
    s[4 * k] = w.x;
    s[4 * k + 1] = w.y;
    s[4 * k + 2] = w.z;
    s[4 * k + 3] = w.w;
  }
  const float4* up = reinterpret_cast<const float4*>(
      u + (static_cast<int64_t>(d) * cj + row) * L + l0);
  float x[kVec];
#pragma unroll
  for (int k = 0; k < kVec / 4; ++k) {
    const float4 f = H == 1 ? __ldcs(up + k) : __ldg(up + k);
    x[4 * k] = f.x;
    x[4 * k + 1] = f.y;
    x[4 * k + 2] = f.z;
    x[4 * k + 3] = f.w;
  }
  const uint4 lw = __ldg(reinterpret_cast<const uint4*>(
      lit + static_cast<int64_t>(d) * L + l0));
  const uint32_t lits[4] = {lw.x, lw.y, lw.z, lw.w};
  update16<T>(s, x, lits, c_out[q] != 0, t1[q] != 0, t2[q] != 0,
              ps_r != nullptr ? ps_r[r] : ps_v,
              pe_r != nullptr ? pe_r[r] : pe_v, n_states);

  uint4* op = reinterpret_cast<uint4*>(out + q * L + l0);
#pragma unroll
  for (int k = 0; k < kWords / 4; ++k)
    op[k] = make_uint4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(void* out, const void* ta, const void* lit, const void* c_out,
           const void* t1, const void* t2, const void* u, const void* ps_r,
           const void* pe_r, float ps, float pe, int R, int D, int cj, int L,
           int n_states, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L % kVec == 0 && aligned16(out) && aligned16(ta) && aligned16(lit) &&
      aligned16(u)) {
    const int H = R / D;
    const int64_t tiles =
        (static_cast<int64_t>(cj) * (L / kVec) + kThreads - 1) / kThreads;
    const dim3 grid(static_cast<unsigned>(tiles * H), D);
    feedback_plane_vec_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<T*>(out), static_cast<const T*>(ta),
        static_cast<const uint8_t*>(lit), static_cast<const uint8_t*>(c_out),
        static_cast<const uint8_t*>(t1), static_cast<const uint8_t*>(t2),
        static_cast<const float*>(u), static_cast<const float*>(ps_r),
        static_cast<const float*>(pe_r), ps, pe, cj, L, D, H, n_states);
    return static_cast<int>(cudaGetLastError());
  }
  // x: literal blocks (one warp for a narrow plane, else 128 threads);
  // y: clause rows (looped past 65535); z: replicas.
  const int threads = L <= 32 ? 32 : (L <= 64 ? 64 : 128);
  const dim3 grid((L + threads - 1) / threads, cj < 65535 ? cj : 65535, R);
  feedback_plane_kernel<T><<<grid, threads, 0, st>>>(
      static_cast<T*>(out), static_cast<const T*>(ta),
      static_cast<const uint8_t*>(lit), static_cast<const uint8_t*>(c_out),
      static_cast<const uint8_t*>(t1), static_cast<const uint8_t*>(t2),
      static_cast<const float*>(u), static_cast<const float*>(ps_r),
      static_cast<const float*>(pe_r), ps, pe, cj, L, D, n_states);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8: one bank, p_strengthen / p_erase by value.
extern "C" int feedback_plane_i8(void* out, const void* ta, const void* lit,
                                 const void* c_out, const void* t1,
                                 const void* t2, const void* u, float ps,
                                 float pe, int cj, int L, int n_states,
                                 void* stream) {
  return launch<int8_t>(out, ta, lit, c_out, t1, t2, u, nullptr, nullptr, ps,
                        pe, 1, 1, cj, L, n_states, stream);
}

extern "C" int feedback_plane_i16(void* out, const void* ta, const void* lit,
                                  const void* c_out, const void* t1,
                                  const void* t2, const void* u, float ps,
                                  float pe, int cj, int L, int n_states,
                                  void* stream) {
  return launch<int16_t>(out, ta, lit, c_out, t1, t2, u, nullptr, nullptr,
                         ps, pe, 1, 1, cj, L, n_states, stream);
}

// K9: R banks, literals / u per stream (r % D), p_strengthen / p_erase
// from [R] float32 device arrays.
extern "C" int feedback_plane_replicated_i8(
    void* out, const void* ta, const void* lit, const void* c_out,
    const void* t1, const void* t2, const void* u, const void* ps,
    const void* pe, int R, int D, int cj, int L, int n_states,
    void* stream) {
  return launch<int8_t>(out, ta, lit, c_out, t1, t2, u, ps, pe, 0.f, 0.f, R,
                        D, cj, L, n_states, stream);
}

extern "C" int feedback_plane_replicated_i16(
    void* out, const void* ta, const void* lit, const void* c_out,
    const void* t1, const void* t2, const void* u, const void* ps,
    const void* pe, int R, int D, int cj, int L, int n_states,
    void* stream) {
  return launch<int16_t>(out, ta, lit, c_out, t1, t2, u, ps, pe, 0.f, 0.f, R,
                         D, cj, L, n_states, stream);
}
