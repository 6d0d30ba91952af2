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
//   3. AND-write each op's result into its output column, in turn (two
//      ops of one cycle that write one column leave the AND of both).
// NOP slots do nothing: their all-ones result AND-written into the
// scratch column changes nothing.
//
// What bounds them on the H100
//   Every crossbar word (32 rows) is independent of every other: gathers
//   and writes move along columns inside one word. Device memory sees the
//   state once in and once out: for multpim N=32 at 2^20 rows 2 x 60 MB
//   packed (k1, 0.036 ms at 3.35 TB/s) or 2 x 482 MB as bytes (k2, 0.288
//   ms), the bytes bound. A design that keeps the state in shared memory
//   has a second floor: each real op is 3 operand gathers and one
//   AND-write (a load and a store), about 5 warp-wide shared accesses per
//   32 words. For multpim N=32 (10,271 real ops) at 2^20 rows that is
//   52.6 M wavefronts, 0.20 ms over 132 SMs at one a clock (1,980 MHz).
//   k2 adds its transposes: about C / 4 shared reads and C ballots per
//   word in, C broadcast reads and C / 4 shared stores per word out.
//
// One engine serves both kernels: crossbar_kernel<S, IO> runs the
// command stream over a tile of bit-plane words; IO loads the tile from
// the state and stores it back. k1's IO (Words) copies int32 words; k2's
// (Bytes) packs 32 rows of bytes into each word in the kernel and unpacks
// them on the way out, so k2 is k1's computation with another load and
// store, and one byte a cell costs it nothing inside the cycle loop.
//
// The engine's design
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
//   * k2's load and store (Bytes): a block's 32 B rows are one
//     contiguous stretch of bytes. A word's 32 x C bytes come into a
//     staging buffer by 16-byte cp.async; lane l reads row l four
//     columns at a time, and 32 ballots make 32 column words, lane i
//     keeping column c0 + i: 32 rows of a column cost one ballot, not
//     32 byte loads. Out, lane l takes bit l of each column word into
//     row l's bytes in the buffer, and all threads copy the word out in
//     16-byte stores. The buffer overlays the ring, which is filled
//     after the load and dead after the last step, so k2 needs k1's
//     shared memory plus 32 C + 48 - 2,048 bytes (75,760 B at C = 460):
//     3 blocks an SM, as k1. Measured against it (PERF.md): two buffers
//     (2 blocks an SM), 16-row chunks in two buffers, and lanes reading
//     or writing device memory directly were all slower or no faster.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

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

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
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

// How the engine sees its block's tile: column c of word w at
// sm[c * ld + w], words past `here` zeros; `rows` rows of the state (k2);
// `stage` k2's staging buffer (over the ring).
struct Block {
  uint32_t* sm;
  int ld;
  int B;                // words per block
  int here;             // words of this block in the state
  int rows;             // rows of this block in the state (k2)
  int n_cols;
  long long first;      // the block's first word
  unsigned char* stage;
};

// k1's tile IO: (n_words, C) int32 words, one word per cell.
struct Words {
  __host__ __device__ static int words(int n_words) { return n_words; }
  static size_t stage_bytes(int) { return 0; }

  // Word w is a contiguous row of the state; the threads copy 32 S
  // consecutive cells of it at a time (coalesced) with cp.async, each
  // down its tile row (banks c + w, all distinct), so the whole tile is
  // in flight at once. Words past `here` are zero-filled. Completed by
  // the engine's cp.async.wait_all.
  template <int S>
  static __device__ void load(const Block& b, const void* st_in) {
    const uint32_t* src =
        static_cast<const uint32_t*>(st_in) + b.first * b.n_cols;
    for (int w = 0; w < b.B; ++w)
      for (int c = threadIdx.x; c < b.n_cols; c += 32 * S)
        cp4(b.sm + c * b.ld + w,
            w < b.here ? src + (long long)w * b.n_cols + c : src,
            w < b.here);
  }

  // Coalesced stores, LU in flight per thread.
  template <int S>
  static __device__ void store(const Block& b, void* st_out) {
    uint32_t* dst = static_cast<uint32_t*>(st_out) + b.first * b.n_cols;
    const int avail = b.here * b.n_cols;
    for (int i0 = 0; i0 < avail; i0 += 32 * S * LU) {
      uint32_t v[LU];
#pragma unroll
      for (int u = 0; u < LU; ++u) {
        const int k = i0 + 32 * S * u + threadIdx.x;
        const int w = k / b.n_cols;
        v[u] = k < avail ? b.sm[(k - w * b.n_cols) * b.ld + w] : 0u;
      }
#pragma unroll
      for (int u = 0; u < LU; ++u) {
        const int k = i0 + 32 * S * u + threadIdx.x;
        if (k < avail) dst[k] = v[u];
      }
    }
  }
};

// Word w of a k2 block: the rows 32 w .. 32 w + 31 of the block, bytes
// [32 w C, 32 w C + rows C) of its stretch of the state, row-major, in
// the staging buffer. Pack it into the tile: lane l reads row l (four
// columns a 32-bit load, funnel-shifted, so any C works), and 32 ballots
// over a column group give its 32 column words; lane i keeps column
// c0 + i and stores it down its tile row (banks c0 + i + w, all
// distinct). Rows past `rows` read as zeros; reads past a row's last
// column stay inside the buffer's padding and feed only columns >= C,
// which are not stored. Warp k takes the column groups = k mod S.
template <int S>
__device__ __forceinline__ void pack_word(const Block& b, int w, int rows) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(b.stage);
  const int lane = threadIdx.x & 31;
  const int row0 = lane * b.n_cols;          // this lane's row, in bytes
  const int sh = 8 * (row0 & 3);
  const bool ok = lane < rows;
  for (int c0 = 32 * (threadIdx.x >> 5); c0 < b.n_cols; c0 += 32 * S) {
    const int q = (row0 + c0) >> 2;
    uint32_t lo = ok ? p[q] : 0u;
    uint32_t keep = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t hi = ok ? p[q + k + 1] : 0u;
      const uint32_t v = __funnelshift_r(lo, hi, sh);
      lo = hi;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t m = __ballot_sync(FULL, (v >> (8 * j)) & 1u);
        if (lane == 4 * k + j) keep = m;
      }
    }
    if (c0 + lane < b.n_cols) b.sm[(c0 + lane) * b.ld + w] = keep;
  }
}

// Unpack word w of the tile into the staging buffer (row-major): lane l
// writes row l, four columns at a time from bit l of their column words
// (broadcast reads), as one 32-bit store where C is a multiple of 4,
// else byte by byte. Rows past `rows` are not written. Warp k takes the
// 4-column groups = k mod S.
template <int S>
__device__ __forceinline__ void unpack_word(const Block& b, int w, int rows) {
  const int lane = threadIdx.x & 31;
  if (lane >= rows) return;
  unsigned char* row = b.stage + lane * b.n_cols;
  const bool whole = (b.n_cols & 3) == 0;
  for (int c0 = 4 * (threadIdx.x >> 5); c0 < b.n_cols; c0 += 4 * S) {
    uint32_t v = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < b.n_cols)
        v |= ((b.sm[(c0 + j) * b.ld + w] >> lane) & 1u) << (8 * j);
    if (whole) {
      *reinterpret_cast<uint32_t*>(row + c0) = v;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < b.n_cols) row[c0 + j] = (unsigned char)(v >> (8 * j));
    }
  }
}

// k2's tile IO: (n_rows, C) bytes holding 0/1, 32 rows packed into each
// tile word in the kernel (bit l of word w = row 32 w + l of the block,
// the order of core/bits.pack_rows), a word at a time through one
// staging buffer that overlays the ring: in, the word's bytes come by
// 16-byte cp.async and are packed from the buffer; out, the word is
// unpacked into the buffer and copied out in 16-byte stores. The state
// must be 16-byte aligned (the wrapper's rule).
struct Bytes {
  __host__ __device__ static int words(int n_rows) {
    return (n_rows + 31) / 32;
  }
  // One word's bytes, padded for pack_word's reads past the last row
  // (up to byte 32 C + 34).
  static size_t stage_bytes(int n_cols) { return 32 * (size_t)n_cols + 48; }

  template <int S>
  static __device__ void load(const Block& b, const void* st_in) {
    const unsigned char* src = static_cast<const unsigned char*>(st_in) +
                               b.first * 32 * b.n_cols;
    const int wb = 32 * b.n_cols;               // bytes a word, 16 | wb
    for (int w = 0; w < b.here; ++w) {
      const int rows = min(32, b.rows - 32 * w);
      const unsigned char* from = src + (long long)w * wb;
      const int n = rows * b.n_cols;
      for (int i = threadIdx.x; i < n / 16; i += 32 * S)
        cp16(b.stage + 16 * i, from + 16 * i);
      for (int i = n / 16 * 16 + threadIdx.x; i < n; i += 32 * S)
        b.stage[i] = from[i];                   // a ragged word's tail
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      pack_word<S>(b, w, rows);
      __syncthreads();                          // the buffer is free again
    }
    for (int i = threadIdx.x; i < (b.B - b.here) * b.n_cols; i += 32 * S) {
      const int w = b.here + i / b.n_cols;
      b.sm[(i % b.n_cols) * b.ld + w] = 0u;     // words past the state
    }
  }

  template <int S>
  static __device__ void store(const Block& b, void* st_out) {
    unsigned char* dst = static_cast<unsigned char*>(st_out) +
                         b.first * 32 * b.n_cols;
    const int wb = 32 * b.n_cols;
    for (int w = 0; w < b.here; ++w) {
      const int rows = min(32, b.rows - 32 * w);
      unsigned char* to = dst + (long long)w * wb;
      unpack_word<S>(b, w, rows);
      __syncthreads();
      const int n = rows * b.n_cols;
      for (int i = threadIdx.x; i < n / 16; i += 32 * S)
        reinterpret_cast<uint4*>(to)[i] =
            reinterpret_cast<const uint4*>(b.stage)[i];
      for (int i = n / 16 * 16 + threadIdx.x; i < n; i += 32 * S)
        to[i] = b.stage[i];
      __syncthreads();                          // the buffer is free again
    }
  }
};

// The engine. S warps share one tile of up to 32 words (lane = word),
// loaded and stored by IO. The command stream comes through a shared
// ring of 4 quarters, refilled a quarter at a time with cp.async by all
// threads at step boundaries, at least two quarters ahead of the reader.
// Each step's SET entries and ops are split between the warps, warp k
// taking those = k (mod S); a barrier separates a step's SETs from its
// ops and closes each step. Shared memory: the tile, then from the next
// 16-byte boundary the ring and the held staging area, which IO's
// staging buffers overlay: IO loads the tile before the ring is filled
// and stores it after the last step.
template <int S, class IO>
__global__ void __launch_bounds__(32 * S)
crossbar_kernel(const void* __restrict__ st_in, void* __restrict__ st_out,
                int n_items, int n_cols, int words_per_block,
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
  const int here =
      (int)min((long long)B, (long long)IO::words(n_items) - first);
  const int tile_words = (n_cols + 2) * ld;
  uint2* ring = reinterpret_cast<uint2*>(sm + ((tile_words + 3) & ~3));
  const int ring_size = 4 * quarter;
  uint32_t* staging = reinterpret_cast<uint32_t*>(ring + ring_size) + lane;
  const Block blk{sm, ld, B, here,
                  (int)min((long long)32 * B, (long long)n_items - 32 * first),
                  n_cols, first, reinterpret_cast<unsigned char*>(ring)};

  // The tile, then the first four quarters of the stream, so that every
  // ring slot holds an entry.
  IO::template load<S>(blk, st_in);
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
  IO::template store<S>(blk, st_out);
}

template <int S, class IO>
int launch_one(const void* st_in, void* st_out, int n_items, int n_cols,
               const void* cmd, int n_cmd, int n_steps, int quarter,
               int held, size_t smem, int words_per_block, void* stream) {
  auto kernel = crossbar_kernel<S, IO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // All of the SM's unified memory as shared memory, so that as many
  // blocks fit as the tile allows (the default carveout may hold one).
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int n_words = IO::words(n_items);
  const int grid = (n_words + words_per_block - 1) / words_per_block;
  if (grid > 0) {
    kernel<<<grid, 32 * S, smem, (cudaStream_t)stream>>>(
        st_in, st_out, n_items, n_cols, words_per_block, (const uint2*)cmd,
        n_cmd, n_steps, quarter, held);
  }
  return (int)cudaGetLastError();
}

// Both entries: the command stream cmd (n_cmd,) of 64-bit entries,
// n_steps steps of at most max_step entries each (n_cmd >= 1). held != 0
// when some cycle reads a column it writes or writes one twice; max_ops
// bounds a step's ops (sizes the held staging area). Four warps share a
// block, or one when held. words_per_block (at most 32) is halved until
// the block's shared memory fits; cudaErrorInvalidValue if even one word
// does not.
template <class IO>
int launch(const void* st_in, void* st_out, int n_items, int n_cols,
           const void* cmd, int n_cmd, int n_steps, int max_step, int held,
           int max_ops, int words_per_block, void* stream) {
  if (n_cols < 1 || n_cols + 2 > 4096 || words_per_block < 1 ||
      words_per_block > 32 || n_cmd < 1 || n_steps < 0 || max_step < 0 ||
      max_ops < 0 || n_items < 0)
    return (int)cudaErrorInvalidValue;
  int quarter = 64;            // a power of two > max_step
  while (quarter <= max_step) quarter *= 2;
  const size_t staged = held ? ((max_ops + G - 1) / G) * G * 32 : 0;
  // The tile, then (16-byte aligned) the ring and the held staging
  // area, or IO's staging buffers where they are larger.
  auto smem_bytes = [&](int b) {
    const size_t tile_words = ((size_t)(n_cols + 2) * (b + 1) + 3) / 4 * 4;
    return tile_words * 4 + std::max((2 * 4 * (size_t)quarter + staged) * 4,
                                     IO::stage_bytes(n_cols));
  };
  while (words_per_block > 1 && smem_bytes(words_per_block) > kMaxSmem)
    words_per_block /= 2;
  const size_t smem = smem_bytes(words_per_block);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (held)
    return launch_one<1, IO>(st_in, st_out, n_items, n_cols, cmd, n_cmd,
                             n_steps, quarter, held, smem, words_per_block,
                             stream);
  return launch_one<4, IO>(st_in, st_out, n_items, n_cols, cmd, n_cmd,
                           n_steps, quarter, held, smem, words_per_block,
                           stream);
}

}  // namespace

extern "C" {

// K1: packed state, (n_words, n_cols) 32-bit words, 32 rows per word.
int k1_packed(const void* st_in, void* st_out, int n_words, int n_cols,
              const void* cmd, int n_cmd, int n_steps, int max_step,
              int held, int max_ops, int words_per_block, void* stream) {
  return launch<Words>(st_in, st_out, n_words, n_cols, cmd, n_cmd, n_steps,
                       max_step, held, max_ops, words_per_block, stream);
}

// K2: unpacked state, (n_rows, n_cols) bytes holding 0/1, 16-byte
// aligned; the same command stream and rules as K1, words_per_block in
// 32-row words.
int k2_unpacked(const void* st_in, void* st_out, int n_rows, int n_cols,
                const void* cmd, int n_cmd, int n_steps, int max_step,
                int held, int max_ops, int words_per_block, void* stream) {
  return launch<Bytes>(st_in, st_out, n_rows, n_cols, cmd, n_cmd, n_steps,
                       max_step, held, max_ops, words_per_block, stream);
}

}  // extern "C"
