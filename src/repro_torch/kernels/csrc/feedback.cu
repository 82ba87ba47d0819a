// Fused Type I/II TA-bank update for Hopper (sm_90a): the CUDA twin of the
// Pallas kernel feedback_plane (K8) in the reference package's
// kernels/feedback.py.
//
// One elementwise pass over the flattened [CJ, L] bank, templated on the
// int8 and int16 TA types. Per-row control is three 1-byte bool vectors
// [CJ] (clause output, Type I, Type II); p_strengthen and p_erase are
// float32 values passed by value; the uniforms u [CJ, L] are read from
// memory, because they come from the port's threefry and that keeps the
// result bitwise the reference's.
//
//   include = ta > N
//   d1 = (clause & lit) ? (u < p_strengthen) : -(u < p_erase)
//   d2 = clause & ~lit & ~include
//   ta' = clip(ta + (type1 ? d1 : 0) + (type2 ? d2 : 0), 1, 2N)
//
// Bound: memory. Each TA is read and written once, and u (4 bytes a TA)
// is the widest operand. The grid is 2-D, literal blocks by clause rows,
// so a thread finds its element with no division and neighbouring threads
// touch neighbouring addresses. Launch overhead dominates at the main
// path's 1 M TAs.
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
                                      float p_strengthen, float p_erase,
                                      int cj, int L, int n_states) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const bool li = lit[l] != 0;
  for (int row = blockIdx.y; row < cj; row += gridDim.y) {
    const int64_t i = static_cast<int64_t>(row) * L + l;
    const int s = static_cast<int>(ta[i]);
    const bool c = c_out[row] != 0;
    const float x = u[i];
    const int d1 = (c && li) ? static_cast<int>(x < p_strengthen)
                             : -static_cast<int>(x < p_erase);
    const int d2 = static_cast<int>(c && !li && s <= n_states);
    int v = s + (t1[row] != 0 ? d1 : 0) + (t2[row] != 0 ? d2 : 0);
    v = v < 1 ? 1 : (v > 2 * n_states ? 2 * n_states : v);
    out[i] = static_cast<T>(v);
  }
}

template <typename T>
int launch(void* out, const void* ta, const void* lit, const void* c_out,
           const void* t1, const void* t2, const void* u, float ps, float pe,
           int cj, int L, int n_states, void* stream) {
  // x: literal blocks of 128 threads; y: clause rows (looped past 65535).
  const int threads = 128;
  const dim3 grid((L + threads - 1) / threads, cj < 65535 ? cj : 65535);
  feedback_plane_kernel<T><<<grid, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(out), static_cast<const T*>(ta),
      static_cast<const uint8_t*>(lit), static_cast<const uint8_t*>(c_out),
      static_cast<const uint8_t*>(t1), static_cast<const uint8_t*>(t2),
      static_cast<const float*>(u), ps, pe, cj, L, n_states);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int feedback_plane_i8(void* out, const void* ta, const void* lit,
                                 const void* c_out, const void* t1,
                                 const void* t2, const void* u, float ps,
                                 float pe, int cj, int L, int n_states,
                                 void* stream) {
  return launch<int8_t>(out, ta, lit, c_out, t1, t2, u, ps, pe, cj, L,
                        n_states, stream);
}

extern "C" int feedback_plane_i16(void* out, const void* ta, const void* lit,
                                  const void* c_out, const void* t1,
                                  const void* t2, const void* u, float ps,
                                  float pe, int cj, int L, int n_states,
                                  void* stream) {
  return launch<int16_t>(out, ta, lit, c_out, t1, t2, u, ps, pe, cj, L,
                         n_states, stream);
}
