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
// once per stream) is the widest operand. The grid is 3-D, literal blocks
// by clause rows by replicas, so a thread finds its element with no
// division and neighbouring threads touch neighbouring addresses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
    const int s = static_cast<int>(ta[i]);
    const bool c = c_out[q] != 0;
    const float x = u[(rows_d + row) * L + l];
    const int d1 = (c && li) ? static_cast<int>(x < p_strengthen)
                             : -static_cast<int>(x < p_erase);
    const int d2 = static_cast<int>(c && !li && s <= n_states);
    int v = s + (t1[q] != 0 ? d1 : 0) + (t2[q] != 0 ? d2 : 0);
    v = v < 1 ? 1 : (v > 2 * n_states ? 2 * n_states : v);
    out[i] = static_cast<T>(v);
  }
}

template <typename T>
int launch(void* out, const void* ta, const void* lit, const void* c_out,
           const void* t1, const void* t2, const void* u, const void* ps_r,
           const void* pe_r, float ps, float pe, int R, int D, int cj, int L,
           int n_states, void* stream) {
  // x: literal blocks (one warp for a narrow plane, else 128 threads);
  // y: clause rows (looped past 65535); z: replicas.
  const int threads = L <= 32 ? 32 : (L <= 64 ? 64 : 128);
  const dim3 grid((L + threads - 1) / threads, cj < 65535 ? cj : 65535, R);
  feedback_plane_kernel<T><<<grid, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
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
