// Crossbar program execution on Hopper (sm_90a): the two kernels that
// run a compiled PIM program over crossbar state.
//
// What each function replaces
//   k1_packed   <- src/repro/kernels/crossbar_step.py::_packed_kernel
//                  (the bit-plane packed Pallas kernel, launched by
//                  _run_packed, wrapped by crossbar_run_pallas_packed).
//   k2_unpacked <- src/repro/kernels/crossbar_step.py::_kernel
//                  (the unpacked Pallas kernel, launched by _run,
//                  wrapped by crossbar_run_pallas).
//
// Semantics (both kernels), for every table slot s in order:
//   1. SET the slot's init cells (OR with all-ones);
//   2. gather the operands of all M ops from the pre-slot state and
//      evaluate the gates (NOT, NOR, MIN3 = not-majority, NAND, OR,
//      COPY; NOP = all-ones);
//   3. AND-write each op's result into its output column, in turn.
// NOP slots are skipped: their all-ones result AND-written into the
// scratch column changes nothing, so skipping them is exact.
//
// What bounds them on the H100
//   Every crossbar word (32 rows, k1) or row (k2) is independent of every
//   other: gathers and writes move along columns inside one word. Device
//   memory sees the state once in and once out (2 x 60 MB for multpim
//   N=32 at 2^20 rows: about 36 us at 3.35 TB/s). The real traffic is the
//   per-op column accesses: about 5 word accesses per real gate op per
//   word, 10,271 real ops for multpim N=32, which is ~6.7 GB of
//   shared-memory traffic over 32,768 words.
//
// What the design does about that
//   One thread owns one word (k1) or one row (k2). A block stages B words
//   (rows) in dynamic shared memory, column-major with a padded leading
//   dimension ([C][B+1]), so neighbouring threads touch neighbouring banks
//   and the coalesced tile load/store is conflict-free. Each thread then
//   runs every cycle on its own word with no __syncthreads in the loop;
//   the M results of a cycle are kept in registers (the op loop is fully
//   unrolled to MAXM) before any write. Tables are read from global memory
//   as uniform (broadcast) loads; init cells come as a CSR list so a SET
//   costs one store per cell instead of a pass over all C columns.
//   Staging the tables in shared memory and holding hot columns in
//   registers are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum : int { G_NOP = 0, G_NOT = 1, G_NOR = 2, G_MIN3 = 3, G_NAND = 4,
             G_OR = 5, G_COPY = 6 };

__device__ __forceinline__ uint32_t gate_eval(int g, uint32_t x0,
                                              uint32_t x1, uint32_t x2) {
  switch (g) {
    case G_NOT:  return ~x0;
    case G_NOR:  return ~(x0 | x1);
    case G_MIN3: return ~((x0 & x1) | (x0 & x2) | (x1 & x2));
    case G_NAND: return ~(x0 & x1);
    case G_OR:   return x0 | x1;
    case G_COPY: return x0;
    default:     return 0xFFFFFFFFu;
  }
}

// T is the cell type: uint32_t (32 packed rows) or uint8_t (one row,
// values 0/1). Both share the same bitwise gate evaluation; the 0/1 case
// keeps only bit 0 of the result.
template <typename T, int MAXM>
__global__ void __launch_bounds__(256)
crossbar_kernel(const T* __restrict__ st_in, T* __restrict__ st_out,
                int n_items, int n_cols,
                const int* __restrict__ gate, const int* __restrict__ in0,
                const int* __restrict__ in1, const int* __restrict__ in2,
                const int* __restrict__ outc,
                const int* __restrict__ init_ptr,
                const int* __restrict__ init_cols,
                int n_slots, int m_ops) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int B = blockDim.x;
  const int ld = B + 1;
  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * B;
  const int here = (int)min((long long)B, (long long)n_items - first);

  // Coalesced tile load: the block's `here` items are contiguous rows of
  // the (items, C) state. Slots past `here` hold zeros.
  const T* src = st_in + first * n_cols;
  for (int i = tid; i < B * n_cols; i += B) {
    const int w = i / n_cols;
    const int c = i - w * n_cols;
    sm[c * ld + w] = (w < here) ? src[i] : T(0);
  }
  __syncthreads();

  const T ones = (sizeof(T) == 4) ? T(0xFFFFFFFFu) : T(1);
  T* mine = sm + tid;
  for (int s = 0; s < n_slots; ++s) {
    const int ib = __ldg(init_ptr + s);
    const int ie = __ldg(init_ptr + s + 1);
    for (int k = ib; k < ie; ++k) mine[__ldg(init_cols + k) * ld] = ones;

    const int* g_s = gate + (long long)s * m_ops;
    const int* a_s = in0 + (long long)s * m_ops;
    const int* b_s = in1 + (long long)s * m_ops;
    const int* c_s = in2 + (long long)s * m_ops;
    const int* o_s = outc + (long long)s * m_ops;
    uint32_t res[MAXM];
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      res[m] = 0xFFFFFFFFu;
      if (m < m_ops) {
        const int g = __ldg(g_s + m);
        if (g != G_NOP) {
          const uint32_t x0 = mine[__ldg(a_s + m) * ld];
          const uint32_t x1 = mine[__ldg(b_s + m) * ld];
          const uint32_t x2 = mine[__ldg(c_s + m) * ld];
          res[m] = gate_eval(g, x0, x1, x2);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m < m_ops && __ldg(g_s + m) != G_NOP) {
        T* cell = mine + __ldg(o_s + m) * ld;
        *cell = T(*cell & T(res[m] & uint32_t(ones)));
      }
    }
  }
  __syncthreads();

  T* dst = st_out + first * n_cols;
  for (int i = tid; i < here * n_cols; i += B) {
    const int w = i / n_cols;
    const int c = i - w * n_cols;
    dst[i] = sm[c * ld + w];
  }
}

template <typename T, int MAXM>
int launch_one(const void* st_in, void* st_out, int n_items, int n_cols,
               const void* gate, const void* in0, const void* in1,
               const void* in2, const void* outc, const void* init_ptr,
               const void* init_cols, int n_slots, int m_ops, int block,
               void* stream) {
  const size_t smem = (size_t)n_cols * (block + 1) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      crossbar_kernel<T, MAXM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_items + block - 1) / block;
  if (grid > 0) {
    crossbar_kernel<T, MAXM><<<grid, block, smem, (cudaStream_t)stream>>>(
        (const T*)st_in, (T*)st_out, n_items, n_cols, (const int*)gate,
        (const int*)in0, (const int*)in1, (const int*)in2,
        (const int*)outc, (const int*)init_ptr, (const int*)init_cols,
        n_slots, m_ops);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* st_in, void* st_out, int n_items, int n_cols,
           const void* gate, const void* in0, const void* in1,
           const void* in2, const void* outc, const void* init_ptr,
           const void* init_cols, int n_slots, int m_ops, int block,
           void* stream) {
#define CROSSBAR_LAUNCH(MAXM)                                              \
  return launch_one<T, MAXM>(st_in, st_out, n_items, n_cols, gate, in0,   \
                             in1, in2, outc, init_ptr, init_cols, n_slots, \
                             m_ops, block, stream)
  if (m_ops <= 4) CROSSBAR_LAUNCH(4);
  if (m_ops <= 32) CROSSBAR_LAUNCH(32);
  if (m_ops <= 64) CROSSBAR_LAUNCH(64);
  if (m_ops <= 128) CROSSBAR_LAUNCH(128);
#undef CROSSBAR_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K1: packed state, (n_words, n_cols) 32-bit words, 32 rows per word.
int k1_packed(const void* st_in, void* st_out, int n_words, int n_cols,
              const void* gate, const void* in0, const void* in1,
              const void* in2, const void* outc, const void* init_ptr,
              const void* init_cols, int n_slots, int m_ops, int block,
              void* stream) {
  return launch<uint32_t>(st_in, st_out, n_words, n_cols, gate, in0, in1,
                          in2, outc, init_ptr, init_cols, n_slots, m_ops,
                          block, stream);
}

// K2: unpacked state, (n_rows, n_cols) bytes holding 0/1.
int k2_unpacked(const void* st_in, void* st_out, int n_rows, int n_cols,
                const void* gate, const void* in0, const void* in1,
                const void* in2, const void* outc, const void* init_ptr,
                const void* init_cols, int n_slots, int m_ops, int block,
                void* stream) {
  return launch<uint8_t>(st_in, st_out, n_rows, n_cols, gate, in0, in1,
                         in2, outc, init_ptr, init_cols, n_slots, m_ops,
                         block, stream);
}

}  // extern "C"
