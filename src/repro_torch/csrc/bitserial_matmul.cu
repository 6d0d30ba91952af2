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
//   sum_k float(x[m][k] & (2^n_bits - 1)) * w[k][n]. For integer w whose
//   sums stay below 2^24 every order of the sums gives the same exact
//   integers; for float w the result is a float32 sum in another order.
//
// The exact bf16 split
//   The TPU kernel decomposes x into 1-bit planes; this one decomposes it
//   into 8-bit planes, so the tensor cores can take them:
//   * x & (2^n - 1) is exactly the sum of P = ceil(n/8) pieces
//     X_p = ((x >> 8p) & 255) * 2^(8p); each has at most 8 significant
//     bits, so it is exact in bf16.
//   * a float32 w is exactly W_0 + W_1 + W_2 (repro_torch.kernels.
//     bitserial_matmul.split_bf16x3): W_0 is w with its low 16 bits
//     cleared (a bf16, by truncation), W_1 the same of the exact remainder
//     w - W_0, and W_2 = w - W_0 - W_1, which has at most 8 significant
//     bits left. Only where W_2 falls below the normal range
//     (|w| < ~1e-30) is it not exact.
//   * bf16 x bf16 products are exact in float32, and mma.sync accumulates
//     in float32. So out = sum_p sum_q X_p @ W_q: 3 bf16 tensor-core
//     products per x piece.
//
// What bounds it on the H100
//   P * 3 * 2 M K N bf16 flops at 989 TFLOP/s dense, against x, w and out
//   moved once over HBM (4 bytes each) at 3.35 TB/s: at M = 256, n = 8 and
//   deepseek-7b's projections 0.026 to 0.140 ms by operations, 0.02 to
//   0.12 ms by bytes.
//
// What the design does about that
//   * A block of (BM/32) x (BN/32) warps owns a BM x BN output tile and
//     loops over K; the grid puts the M blocks fastest, so the blocks that
//     share a w column run together and w comes from HBM about once. The
//     launcher takes the largest tile of 128 x 128, 128 x 64 and 64 x 64
//     that still gives >= 132 blocks (64 x 64 gives >= 256 at every M =
//     256 path shape): larger tiles re-read x and w from L2 fewer times.
//     No split-K, no atomics: the same sums every run.
//   * A 3-stage cp.async ring stages the raw x (int32) and w (float32) K
//     tiles of 32; ragged M, K and N edges are zero-filled by the copy
//     itself. Each thread converts exactly the 16-byte chunks it copied,
//     so the ring needs no barrier: in registers, with integer operations
//     and one fma only (no conversion-pipe instructions), into bf16 pieces
//     in one of two shared buffers (x: P pieces; w: 3), which the warps
//     read into mma fragments with ldmatrix. One __syncthreads per K tile.
//   * Each warp computes 32 x 32 with m16n8k16 bf16 -> f32 mma.sync.
//     A tile's products sum into a fresh accumulator, which is then added
//     to the running sums with float32 adds that round to nearest: the
//     tensor cores' own accumulation may truncate (under one ulp per
//     addition), and this way it only ever truncates sums of one 32-term
//     tile. For integer operands each tile's sum is exact.
//   * Where a K tile's W_1 and W_2 are all zero (integer w, such as the
//     quantized weights of the PIM linear layers), the block skips their
//     two products: __syncthreads_or after the conversion says so.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;
constexpr int STAGES = 3;

// Tile geometry of a block of WM x WN warps, each computing 32 x 32.
template <int WM, int WN>
struct Tile {
  static constexpr int BM = 32 * WM;
  static constexpr int BN = 32 * WN;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int A_LD = BK + 8;   // bf16 row stride of an x piece
  static constexpr int B_LD = BN + 8;   // bf16 row stride of a w piece
  static constexpr int RAW_X = BM * BK;                  // int32 a stage
  static constexpr int RAW_W = BK * BN;                  // float a stage
  static constexpr int RAW_BYTES = (RAW_X + RAW_W) * 4;
  static constexpr int A_PIECE = BM * A_LD;              // bf16 a piece
  static constexpr int B_PIECE = BK * B_LD;
  static constexpr int X_CHUNKS = RAW_X / 4 / THREADS;   // 16 B a thread
  static constexpr int W_CHUNKS = RAW_W / 4 / THREADS;
  template <int P>
  __host__ __device__ static constexpr int conv_bytes() {
    return (P * A_PIECE + 3 * B_PIECE) * 2;
  }
  template <int P>
  __host__ __device__ static constexpr int smem_bytes() {
    return STAGES * RAW_BYTES + 2 * conv_bytes<P>();
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero-fill: copies src_bytes (0 or the full size) and
// fills the rest of the destination with zeros.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b, or d = a b when `fresh` (the accumulator's zeros come from
// the zero register, not from instructions that clear it).
template <bool fresh>
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(fresh ? z : d[0]), "f"(fresh ? z : d[1]), "f"(fresh ? z : d[2]),
        "f"(fresh ? z : d[3]));
}

// The bf16 of the 8-bit integer v * 2^(8p), exact: v | 0x4B000000 is the
// float 2^23 + v, so subtracting 2^23 (scaled by 2^(8p) in the same fma)
// gives v * 2^(8p) with its low 16 bits zero. Returned as float bits.
template <int P>
__device__ __forceinline__ uint32_t x_piece(uint32_t v) {
  const float big = __uint_as_float(((v >> (8 * P)) & 0xFFu) | 0x4B000000u);
  const float scale = (float)(1u << (8 * P));
  return __float_as_uint(fmaf(big, scale, -8388608.0f * scale));
}

// Two bf16 (as the high halves of float bits) packed lo | hi << 16.
__device__ __forceinline__ uint32_t pack_hi(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

// Chunk i of this thread: 4 consecutive int32 of x (row r, column kc of
// the K tile) or 4 consecutive floats of w (row r = k, column nc). The
// copy and the conversion use the same map, so each thread reads back
// only what it copied.
template <class T>
__device__ __forceinline__ void x_chunk(int tid, int i, int& r, int& kc) {
  const int c = tid + i * T::THREADS;
  r = c >> 3;
  kc = (c & 7) * 4;
}
template <class T>
__device__ __forceinline__ void w_chunk(int tid, int i, int& r, int& nc) {
  const int c = tid + i * T::THREADS;
  r = c / (T::BN / 4);
  nc = (c % (T::BN / 4)) * 4;
}

template <class T, bool VEC>
__device__ __forceinline__ void load_stage(unsigned char* raw,
                                           const int32_t* __restrict__ x,
                                           const float* __restrict__ w,
                                           int M, int K, int N, int m0,
                                           int n0, int k0, int tid) {
  int32_t* xr = reinterpret_cast<int32_t*>(raw);               // [BM][BK]
  float* wr = reinterpret_cast<float*>(raw + T::RAW_X * 4);    // [BK][BN]
#pragma unroll
  for (int i = 0; i < T::X_CHUNKS; ++i) {
    int r, kc;
    x_chunk<T>(tid, i, r, kc);
    const int m = m0 + r, k = k0 + kc;
    if (VEC) {
      const bool ok = m < M && k < K;
      cp16(xr + r * BK + kc, ok ? x + (size_t)m * K + k : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = m < M && k + e < K;
        cp4(xr + r * BK + kc + e, ok ? x + (size_t)m * K + k + e : x, ok);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < T::W_CHUNKS; ++i) {
    int r, nc;
    w_chunk<T>(tid, i, r, nc);
    const int k = k0 + r, n = n0 + nc;
    if (VEC) {
      const bool ok = k < K && n < N;
      cp16(wr + r * T::BN + nc, ok ? w + (size_t)k * N + n : w, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k < K && n + e < N;
        cp4(wr + r * T::BN + nc + e, ok ? w + (size_t)k * N + n + e : w, ok);
      }
    }
  }
}

// This thread's chunks of a raw stage -> bf16 pieces in shared memory.
// Returns nonzero if any of its w elements has a nonzero W_1 or W_2.
template <class T, int P>
__device__ __forceinline__ int convert_stage(const unsigned char* raw,
                                             uint16_t* As, uint16_t* Bs,
                                             uint32_t mask, int tid) {
  const int32_t* xr = reinterpret_cast<const int32_t*>(raw);
  const float* wr = reinterpret_cast<const float*>(raw + T::RAW_X * 4);
#pragma unroll
  for (int i = 0; i < T::X_CHUNKS; ++i) {
    int r, kc;
    x_chunk<T>(tid, i, r, kc);
    const int4 v = *reinterpret_cast<const int4*>(xr + r * BK + kc);
    const uint32_t e[4] = {(uint32_t)v.x & mask, (uint32_t)v.y & mask,
                           (uint32_t)v.z & mask, (uint32_t)v.w & mask};
#pragma unroll
    for (int p = 0; p < P; ++p) {
      uint32_t f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[j] = p == 0 ? x_piece<0>(e[j]) : p == 1 ? x_piece<1>(e[j])
                                                  : x_piece<2>(e[j]);
      }
      *reinterpret_cast<uint2*>(As + p * T::A_PIECE + r * T::A_LD + kc) =
          make_uint2(pack_hi(f[0], f[1]), pack_hi(f[2], f[3]));
    }
  }
  uint32_t rest = 0;
#pragma unroll
  for (int i = 0; i < T::W_CHUNKS; ++i) {
    int r, nc;
    w_chunk<T>(tid, i, r, nc);
    const float4 v = *reinterpret_cast<const float4*>(wr + r * T::BN + nc);
    const float e[4] = {v.x, v.y, v.z, v.w};
    uint32_t b0[4], b1[4], b2[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b0[j] = __float_as_uint(e[j]) & 0xFFFF0000u;
      const float r1 = e[j] - __uint_as_float(b0[j]);          // exact
      b1[j] = __float_as_uint(r1) & 0xFFFF0000u;
      b2[j] = __float_as_uint(r1 - __uint_as_float(b1[j]));     // exact
      rest |= b1[j] | b2[j];
    }
    uint16_t* dst = Bs + r * T::B_LD + nc;
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_hi(b0[0], b0[1]), pack_hi(b0[2], b0[3]));
    *reinterpret_cast<uint2*>(dst + T::B_PIECE) =
        make_uint2(pack_hi(b1[0], b1[1]), pack_hi(b1[2], b1[3]));
    *reinterpret_cast<uint2*>(dst + 2 * T::B_PIECE) =
        make_uint2(pack_hi(b2[0], b2[1]), pack_hi(b2[2], b2[3]));
  }
  return rest != 0u;
}

template <class T, int P, bool VEC>
__global__ void __launch_bounds__(T::THREADS)
k3_kernel(const int32_t* __restrict__ x, const float* __restrict__ w,
          float* __restrict__ out, int M, int K, int N, uint32_t mask) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* raw = smem;                            // STAGES raw tiles
  unsigned char* conv = smem + STAGES * T::RAW_BYTES;   // 2 piece buffers
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp % (T::BM / 32)) * 32;   // the warp's 32 x 32 sub-tile
  const int wn = (warp / (T::BM / 32)) * 32;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int KT = (K + BK - 1) / BK;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage<T, VEC>(raw + s * T::RAW_BYTES, x, w, M, K, N, m0, n0,
                         s * BK, tid);
    cp_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    // This thread's copies of tile kt have landed; it alone reads them,
    // and it alone refills the slot of tile kt - 1 below.
    cp_wait<STAGES - 2>();
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      load_stage<T, VEC>(raw + (nk % STAGES) * T::RAW_BYTES, x, w, M, K, N,
                         m0, n0, nk * BK, tid);
    cp_commit();
    uint16_t* As = reinterpret_cast<uint16_t*>(
        conv + (kt & 1) * T::template conv_bytes<P>());
    uint16_t* Bs = As + P * T::A_PIECE;
    // One barrier: the pieces of tile kt are complete, and every warp is
    // past its products of tile kt - 2, which used this buffer.
    const int wide = __syncthreads_or(convert_stage<T, P>(
        raw + (kt % STAGES) * T::RAW_BYTES, As, Bs, mask, tid));
    const int nq = wide ? 3 : 1;

    float part[2][4][4];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[P][2][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(a[p][i], As + p * T::A_PIECE +
                               (wm + 16 * i + (lane & 15)) * T::A_LD + ks +
                               (lane >> 4) * 8);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (q < nq) {
          uint32_t b[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            ldsm_x4_t(b[j], Bs + q * T::B_PIECE +
                                (ks + (lane & 15)) * T::B_LD + wn + 16 * j +
                                (lane >> 4) * 8);
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const uint32_t b0 = b[j >> 1][(j & 1) * 2];
                const uint32_t b1 = b[j >> 1][(j & 1) * 2 + 1];
                if (ks == 0 && q == 0 && p == 0)
                  mma_bf16<true>(part[i][j], a[p][i], b0, b1);
                else
                  mma_bf16<false>(part[i][j], a[p][i], b0, b1);
              }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_wait<0>();

  // Accumulator layout of m16n8: c0, c1 at (row g, cols 2t, 2t+1), c2, c3
  // at row g + 8.
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t4;
        float* o = out + (size_t)m * N + n;
        if (n + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (n < N) o[0] = acc[i][j][2 * h];
          if (n + 1 < N) o[1] = acc[i][j][2 * h + 1];
        }
      }
    }
  }
}

template <class T, int P, bool VEC>
int launch(const void* x, const void* w, void* out, int M, int K, int N,
           uint32_t mask, void* stream) {
  const int smem = T::template smem_bytes<P>();
  cudaError_t err = cudaFuncSetAttribute(
      k3_kernel<T, P, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  // All of the SM's unified memory as shared memory, so that as many
  // blocks fit as the tile allows (the default carveout may hold one).
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k3_kernel<T, P, VEC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const unsigned gy = (unsigned)((N + T::BN - 1) / T::BN);
  if (gy > 65535u) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((M + T::BM - 1) / T::BM), gy);
  k3_kernel<T, P, VEC><<<grid, T::THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const float*)w, (float*)out, M, K, N, mask);
  return (int)cudaGetLastError();
}

template <class T, int P>
int launch_p(const void* x, const void* w, void* out, int M, int K, int N,
             uint32_t mask, void* stream) {
  // 16-byte copies need 16-byte aligned rows of x and w.
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  return vec ? launch<T, P, true>(x, w, out, M, K, N, mask, stream)
             : launch<T, P, false>(x, w, out, M, K, N, mask, stream);
}

template <class T>
int launch_t(const void* x, const void* w, void* out, int M, int K, int N,
             int n_bits, void* stream) {
  const uint32_t mask = (uint32_t)((1u << n_bits) - 1u);
  const int pieces = K == 0 ? 1 : (n_bits + 7) / 8;
  if (pieces == 1) return launch_p<T, 1>(x, w, out, M, K, N, mask, stream);
  if (pieces == 2) return launch_p<T, 2>(x, w, out, M, K, N, mask, stream);
  if (pieces == 3) return launch_p<T, 3>(x, w, out, M, K, N, mask, stream);
  return (int)cudaErrorInvalidValue;
}

long long blocks(int M, int N, int bm, int bn) {
  return (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

}  // namespace

extern "C" {

// x (M, K) int32, w (K, N) float32, out (M, N) float32, all contiguous
// on the device; launches on `stream` and returns cudaGetLastError().
// n_bits in [1, 30]; with K > 0 at most 24 (three 8-bit pieces of x).
// The tile is the largest of 128 x 128, 128 x 64 and 64 x 64 that gives
// >= 132 blocks (64 x 64 below that).
int k3_bitserial_matmul(const void* x, const void* w, void* out, int M,
                        int K, int N, int n_bits, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || n_bits < 1 || n_bits > 30)
    return (int)cudaErrorInvalidValue;
  if (blocks(M, N, 128, 128) >= 132)
    return launch_t<Tile<4, 4>>(x, w, out, M, K, N, n_bits, stream);
  if (blocks(M, N, 128, 64) >= 132)
    return launch_t<Tile<4, 2>>(x, w, out, M, K, N, n_bits, stream);
  return launch_t<Tile<2, 2>>(x, w, out, M, K, N, n_bits, stream);
}

}  // extern "C"
