// Bit-serial fixed-point matmul on Hopper (sm_90a): K3.
//
// What it replaces
//   k3_bitserial_matmul <- src/repro/kernels/bitserial_matmul.py::_kernel
//                          (the Pallas kernel launched by _run, wrapped by
//                          bitserial_matmul_pallas).
//
// Semantics
//   out[m][n] = sum_j 2^j sum_k X_j[m][k] w[k][n] over the n_bits low bit
//   planes X_j = (x >> j) & 1 of the int32 x, in float32: that is
//   sum_k float(x[m][k] & (2^n_bits - 1)) * w[k][n]. The kernel takes this
//   direct form (one FMA per term) instead of the TPU's n_bits plane
//   products. For integer w whose sums stay below 2^24 both forms give the
//   same exact integers; for float w both are float32 sums, in another
//   order.
//
// What bounds it on the H100
//   2 M K N flops on the CUDA cores, at the float32 rate outside the tensor
//   cores (67 TFLOP/s): at M = 256 and deepseek-7b's projections that is
//   0.13 to 0.69 ms, against 0.02 to 0.12 ms to move x, w and out once over
//   HBM, so it is bound by operations. The plane form would do n_bits times
//   the flops. Tensor cores are out: TF32 keeps a 10-bit mantissa and
//   breaks the exact-integer contract, and int8 IMMA would need an integer
//   w, which K3 does not assume.
//
// What the design does about that
//   One block owns a 64 x 64 output tile and loops over K itself (the TPU
//   kernel carried its accumulator across a sequential K grid; Hopper
//   blocks run in no order). 256 threads hold 4 x 4 outputs each in
//   registers, rows ty + 16 i and columns tx + 16 j, so the shared-memory
//   reads broadcast or hit 16 distinct banks. Each K chunk of 32 is staged
//   in shared memory: x read as int32 and converted once (no n_bits float
//   planes in device memory, which would cost n_bits x 4 bytes per x
//   element), w as float32; both tiles are zero-filled past the ragged
//   edges, and the stores are masked. A chunk is summed in registers on its
//   own and then added to the running sums: for integer operands every
//   chunk of 32 terms is exact, and rounding, where the sums pass 2^24,
//   happens once per chunk. No atomics. Double buffering, vector loads and
//   larger per-thread tiles are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int TCOLS = BN / TN;               // 16 threads across N
constexpr int THREADS = (BM / TM) * TCOLS;   // 256

__global__ void __launch_bounds__(THREADS)
k3_kernel(const int32_t* __restrict__ x, const float* __restrict__ w,
          float* __restrict__ out, int M, int K, int N, int32_t mask) {
  // x tile transposed (xs[k][m]) with a padded row, so the store of a
  // warp's 32 consecutive k of one row hits 32 banks.
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TCOLS;
  const int ty = tid / TCOLS;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int s = 0; s < (BM * BK) / THREADS; ++s) {
      const int idx = tid + s * THREADS;
      const int r = idx / BK;           // row of x
      const int c = idx % BK;           // k, fastest: coalesced reads
      const int m = m0 + r;
      const int k = k0 + c;
      float v = 0.f;
      if (m < M && k < K) v = (float)(x[(size_t)m * K + k] & mask);
      xs[c][r] = v;
    }
#pragma unroll
    for (int s = 0; s < (BK * BN) / THREADS; ++s) {
      const int idx = tid + s * THREADS;
      const int r = idx / BN;           // k
      const int c = idx % BN;           // column of w, fastest
      const int k = k0 + r;
      const int n = n0 + c;
      ws[r][c] = (k < K && n < N) ? w[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();

    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + TCOLS * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + TCOLS * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + TCOLS * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + TCOLS * j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x (M, K) int32, w (K, N) float32, out (M, N) float32, all contiguous
// on the device; launches on `stream` and returns cudaGetLastError().
int k3_bitserial_matmul(const void* x, const void* w, void* out, int M,
                        int K, int N, int n_bits, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || n_bits < 1 || n_bits > 30)
    return (int)cudaErrorInvalidValue;
  const unsigned grid_y = (unsigned)((M + BM - 1) / BM);
  if (grid_y > 65535u) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((N + BN - 1) / BN), grid_y);
  const int32_t mask = (int32_t)((1u << n_bits) - 1u);
  k3_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const float*)w, (float*)out, M, K, N, mask);
  return (int)cudaGetLastError();
}

}  // extern "C"
