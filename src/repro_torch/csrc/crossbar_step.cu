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
// Semantics (both kernels), for every cycle in order:
//   1. SET the cycle's init cells (OR with all-ones);
//   2. gather the operands of its real ops from the pre-cycle state and
//      evaluate the gates (NOT, NOR, MIN3 = not-majority, NAND, OR, COPY);
//   3. AND-write each op's result into its output column, in turn.
// NOP slots do nothing: their all-ones result AND-written into the
// scratch column changes nothing.
//
// What bounds them on the H100
//   Every crossbar word (32 rows, k1) or row (k2) is independent of every
//   other: gathers and writes move along columns inside one word. Device
//   memory sees the state once in and once out (2 x 60 MB for multpim
//   N=32 at 2^20 rows: 0.036 ms at 3.35 TB/s, the bytes bound). A design
//   that keeps the state in shared memory has a second floor: each real
//   op is 3 operand gathers and one AND-write (a load and a store), about
//   5 warp-wide shared accesses per 32 words. For multpim N=32 (10,271
//   real ops) at 2^20 rows that is 52.6 M wavefronts, 0.20 ms over 132
//   SMs at one a clock (1,980 MHz).
//
// What k1's design does about that (k2 keeps its first design: one
// thread per row, (T, M) tables read as uniform loads, NOP slots skipped)
//   * One block per 32 words, one lane per word, the words in a
//     [C + 2][B + 1] shared tile (column-major, padded, so an access of
//     all lanes to one column and the tile load and store are free of
//     bank conflicts), loaded with cp.async so that all of it is in
//     flight at once. C x 4 B per word caps an SM at about 120 words (3
//     blocks at C = 460), so one warp per block would leave each
//     scheduler at most one warp, and every latency would show: four
//     warps share a block's tile and split each step's SETs and ops
//     between them (warp k takes those = k mod 4), with a barrier per
//     step (and one between a step's SETs and its ops, where it has
//     both).
//   * A compact command stream (kernels/crossbar_step.py::
//     command_stream): per cycle with work, a header, SET entries of four
//     columns, and one 64-bit record per real op, NOP slots dropped
//     (13,362 entries for multpim N=32 against 611 x 32 slots). A record
//     holds the gate in the form maj(a, b, c) ^ inv, which every gate
//     takes: unary gates read in0 three times, NOR and OR take c from the
//     all-ones column C + 1, NAND from the all-zeros column C. So an op
//     is 3 gathers, 2 LOP3s and an AND-write, with no branch.
//   * The stream off the dependent path: all threads stage it with
//     cp.async into a shared ring of four quarters, refilled at step
//     boundaries more than two quarters ahead of the reader, and every
//     warp reads its entries with broadcast shared loads. No operand load
//     waits on a global load, and the loop carries no register windows
//     (which, rotated, made the compiler wait on each fresh load).
//   * A step's ops in flight together: a warp takes its ops in groups of
//     G = 16, then one each of 8, 4, 2 and 1 as its count needs, and all
//     of a group's gathers, the output cells' old values included, are
//     issued before any write: a group of 16 is 64 independent loads and
//     then 16 plain stores, no load behind a store. This is exact
//     because the host checks every cycle: no op reads a column that an
//     op of the same cycle writes, and no two ops write the same column
//     (true of every program family and of the co-scheduled tables). A
//     table where that fails runs "held", on one warp: the step's results
//     go to a per-thread staging area in shared memory and are
//     AND-written, in turn, after all its gathers.
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

// k2's kernel. T is the cell type: uint8_t, one row, values 0/1; the
// bitwise gate evaluation keeps only bit 0 of the result.
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


// ------------------------------------------------------------------ k1 ----
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int G = 16;  // ops whose gathers are in flight together
constexpr int LU = 8;  // tile stores in flight per thread
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory per block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp4(uint32_t* dst, const uint32_t* src,
                                    bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp8(uint2* dst, const uint2* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

// The block's view of its tile and of the command stream (see
// kernels/crossbar_step.py::command_stream). Every entry is a uint2
// {lo, hi}; read as an op record:
//   lo: a (bits 0-11) | gate (12-14) | inv (19) | b (20-31)
//   hi: c (bits 0-11) | out (20-31)
// result = maj(s[a], s[b], s[c]) ^ (inv ? ~0 : 0). A step's header holds
// its SET-entry count in lo and its op count in hi; a SET entry names
// four columns in the a, b, c and out fields. Entry e sits at
// ring[e & mask] in shared memory.
struct Tile {
  uint32_t* mine;       // this thread's word in column 0 of the tile
  uint32_t* staging;    // this thread's results of a held step
  const uint2* ring;
  int mask;
  int ld;               // tile row stride in words
  bool active;          // lane < words per block
};

// This warp's ops j0, j0 + S, ..., j0 + (GN - 1) S of a step: every
// gather, the output cell's old value included, before any write.
// Without `held` a cycle neither reads a column it writes nor writes one
// column twice, so the writes need no reload, and the warps that split a
// step never touch each other's cells; with it (one warp), the results
// go to the staging area instead, from index j0 - first.
template <int GN, int S>
__device__ __forceinline__ void op_group(const Tile& w, int j0, int first,
                                         bool held) {
  uint32_t x0[GN], x1[GN], x2[GN], old[GN], lo[GN], hi[GN];
#pragma unroll
  for (int u = 0; u < GN; ++u) {
    const uint2 r = w.ring[(j0 + S * u) & w.mask];
    lo[u] = r.x;
    hi[u] = r.y;
    x0[u] = w.mine[(r.x & 0xFFFu) * w.ld];
    x1[u] = w.mine[(r.x >> 20) * w.ld];
    x2[u] = w.mine[(r.y & 0xFFFu) * w.ld];
    old[u] = w.mine[(r.y >> 20) * w.ld];
  }
#pragma unroll
  for (int u = 0; u < GN; ++u) {
    const uint32_t inv = (uint32_t)((int32_t)(lo[u] << 12) >> 31);
    const uint32_t res =
        ((x0[u] & x1[u]) | (x0[u] & x2[u]) | (x1[u] & x2[u])) ^ inv;
    if (held) {
      w.staging[(j0 - first + u) * 32] = res;
    } else if (w.active) {
      w.mine[(hi[u] >> 20) * w.ld] = old[u] & res;
    }
  }
}

// The first index >= lo that is = k (mod S), S a power of two.
template <int S>
__device__ __forceinline__ int own_first(int lo, int k) {
  return lo + ((k - lo) & (S - 1));
}

// S warps share one tile of up to 32 words (lane = word). The command
// stream comes through a shared ring of 4 quarters, refilled a quarter at
// a time with cp.async by all threads at step boundaries, at least two
// quarters ahead of the reader. Each step's SET entries and ops are
// split between the warps, warp k taking those = k (mod S); a barrier
// separates a step's SETs from its ops and closes each step.
template <int S>
__global__ void __launch_bounds__(32 * S)
k1_kernel(const uint32_t* __restrict__ st_in, uint32_t* __restrict__ st_out,
          int n_words, int n_cols, int words_per_block,
          const uint2* __restrict__ cmd, int n_cmd, int n_steps,
          int quarter, int held) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int B = words_per_block;
  const int ld = B + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool active = lane < B;
  const long long first = (long long)blockIdx.x * B;
  const int here = (int)min((long long)B, (long long)n_words - first);
  const int tile_words = (n_cols + 2) * ld;
  uint2* ring = reinterpret_cast<uint2*>(sm + tile_words + (tile_words & 1));
  const int ring_size = 4 * quarter;
  uint32_t* staging = reinterpret_cast<uint32_t*>(ring + ring_size) + lane;

  // Tile load: word w is a contiguous row of the (words, C) state; the
  // threads copy 32 S consecutive cells of it at a time (coalesced) with
  // cp.async, each down its tile row (banks c + w, all distinct), so the
  // whole tile is in flight at once. Words past `here` are zeros. The
  // first four quarters of the stream go with it, so that every ring
  // slot holds an entry.
  const uint32_t* src = st_in + first * n_cols;
  for (int w = 0; w < B; ++w)
    for (int c = tid; c < n_cols; c += 32 * S)
      cp4(sm + c * ld + w, w < here ? src + (long long)w * n_cols + c : src,
          w < here);
  int filled = 4 * quarter;    // entries issued to the ring
  for (int e = tid; e < filled; e += 32 * S)
    cp8(ring + e, cmd + min(e, n_cmd - 1), e < n_cmd);
  if (warp == 0 && active) {
    sm[n_cols * ld + lane] = 0u;              // column C: all zeros
    sm[(n_cols + 1) * ld + lane] = FULL;      // column C + 1: all ones
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  int ready = filled;          // entries complete in the ring

  const Tile me{sm + (active ? lane : 0), staging, ring, ring_size - 1, ld,
                active};
  int pos = 0;                 // the step's header
  uint2 head = ring[0];
  for (int t = 0; t < n_steps; ++t) {
    // Refill the oldest quarter once the reader is within two quarters
    // of the issued end (so the issued end stays over two quarters
    // ahead), and wait only when a step (at most a quarter long) could
    // reach entries not known complete: all but the newest quarter are.
    if (pos >= filled - 2 * quarter) {
      for (int e = filled + tid; e < filled + quarter; e += 32 * S)
        cp8(ring + (e & (ring_size - 1)), cmd + min(e, n_cmd - 1),
            e < n_cmd);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      filled += quarter;
    }
    if (pos + quarter > ready) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
      ready = filled - quarter;
    }
    const int n_set = (int)head.x;
    const int n_op = (int)head.y;
    const int set0 = pos + 1;
    const int op0 = set0 + n_set;
    const int end = op0 + n_op;
    // The next step's header, read now: it lies within this step's
    // quarter of complete entries, and no refill reaches it.
    const uint2 next_head = ring[end & (ring_size - 1)];
    if (n_set > 0) {
      // This warp's SET entries, four in flight.
      for (int e = own_first<S>(set0, warp); e < op0; e += 4 * S) {
        uint2 r[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          r[u] = ring[(e + S * u) & (ring_size - 1)];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (active && e + S * u < op0) {
            me.mine[(r[u].x & 0xFFFu) * ld] = FULL;
            me.mine[(r[u].x >> 20) * ld] = FULL;
            me.mine[(r[u].y & 0xFFFu) * ld] = FULL;
            me.mine[(r[u].y >> 20) * ld] = FULL;
          }
        }
      }
      if (S > 1 && n_op > 0) __syncthreads();   // SET before any gather
    }
    if (n_op > 0) {
      // This warp's ops in groups of 16, then one each of 8, 4, 2 and 1
      // as its count needs: no slot is wasted.
      int j0 = own_first<S>(op0, warp);
      int own = j0 < end ? (end - j0 + S - 1) / S : 0;
      for (; own >= G; own -= G, j0 += S * G)
        op_group<G, S>(me, j0, op0, held);
      if (own & 8) {
        op_group<8, S>(me, j0, op0, held);
        j0 += 8 * S;
      }
      if (own & 4) {
        op_group<4, S>(me, j0, op0, held);
        j0 += 4 * S;
      }
      if (own & 2) {
        op_group<2, S>(me, j0, op0, held);
        j0 += 2 * S;
      }
      if (own & 1) op_group<1, S>(me, j0, op0, held);
      if (held) {   // one warp per block (the launcher's rule)
        for (int j = op0; j < end; ++j) {
          uint32_t* cell =
              me.mine + (ring[j & (ring_size - 1)].y >> 20) * ld;
          if (active) *cell &= me.staging[(j - op0) * 32];
        }
      }
    }
    __syncthreads();
    pos = end;
    head = next_head;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  uint32_t* dst = st_out + first * n_cols;
  const int avail = here * n_cols;
  for (int i0 = 0; i0 < avail; i0 += 32 * S * LU) {
    uint32_t v[LU];
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int k = i0 + 32 * S * u + tid;
      const int w = k / n_cols;
      v[u] = k < avail ? sm[(k - w * n_cols) * ld + w] : 0u;
    }
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int k = i0 + 32 * S * u + tid;
      if (k < avail) dst[k] = v[u];
    }
  }
}

template <int S>
int launch_k1(const void* st_in, void* st_out, int n_words, int n_cols,
              const void* cmd, int n_cmd, int n_steps, int quarter,
              int held, size_t smem, int words_per_block, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      k1_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // All of the SM's unified memory as shared memory, so that as many
  // blocks fit as the tile allows (the default carveout may hold one).
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k1_kernel<S>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_words + words_per_block - 1) / words_per_block;
  if (grid > 0) {
    k1_kernel<S><<<grid, 32 * S, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)st_in, (uint32_t*)st_out, n_words, n_cols,
        words_per_block, (const uint2*)cmd, n_cmd, n_steps, quarter, held);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: packed state, (n_words, n_cols) 32-bit words, 32 rows per word.
// cmd (n_cmd,) 64-bit entries of the command stream, n_steps steps of at
// most max_step entries each (n_cmd >= 1). held != 0 when some cycle
// reads a column it writes or writes one twice; max_ops bounds a step's
// ops (sizes the held staging area). Four warps share a block, or one
// when held. words_per_block (at most 32) is halved until the block's
// shared memory fits; cudaErrorInvalidValue if even one word does not.
int k1_packed(const void* st_in, void* st_out, int n_words, int n_cols,
              const void* cmd, int n_cmd, int n_steps, int max_step,
              int held, int max_ops, int words_per_block, void* stream) {
  if (n_cols < 1 || n_cols + 2 > 4096 || words_per_block < 1 ||
      words_per_block > 32 || n_cmd < 1 || n_steps < 0 || max_step < 0 ||
      max_ops < 0)
    return (int)cudaErrorInvalidValue;
  int quarter = 64;            // a power of two > max_step
  while (quarter <= max_step) quarter *= 2;
  const int staged = held ? ((max_ops + G - 1) / G) * G * 32 : 0;
  auto smem_bytes = [&](int b) {
    const size_t tile_words = (size_t)(n_cols + 2) * (b + 1);
    return (tile_words + (tile_words & 1) + 2 * 4 * (size_t)quarter +
            staged) * 4;
  };
  while (words_per_block > 1 && smem_bytes(words_per_block) > kMaxSmem)
    words_per_block /= 2;
  const size_t smem = smem_bytes(words_per_block);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (held)
    return launch_k1<1>(st_in, st_out, n_words, n_cols, cmd, n_cmd, n_steps,
                        quarter, held, smem, words_per_block, stream);
  return launch_k1<4>(st_in, st_out, n_words, n_cols, cmd, n_cmd, n_steps,
                      quarter, held, smem, words_per_block, stream);
}

// K2: unpacked state, (n_rows, n_cols) bytes holding 0/1; (n_slots,
// m_ops) int32 slot tables and the init cells as CSR.
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
