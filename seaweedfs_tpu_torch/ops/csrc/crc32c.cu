// CRC32C (Castagnoli) of every row of a (B, n) byte array, for Hopper
// (sm_90a).
//
// Replaces seaweedfs_tpu/ops/crc32c_jax.py::crc32c_batch (K5, XLA): the
// same function, CRC32C(row) for each row, bit-exact with the host's
// util/crc32c.crc32c. The XLA program casts the CRC as two GF(2) matrix
// products (the LSB-first bits of each block times BlockMat, the block
// states times PowMat, both mod 2) because a TPU has no fast byte-serial
// path. A GPU thread has one: a table lookup per byte from shared memory.
// So this kernel keeps the algebra only where it pays, in the fold.
//
// Math. With a zero initial register the CRC state is linear over GF(2):
// for a message split as X || Y,
//     state(X || Y) = A8^|Y| (state(X)) ^ state(Y),
// where A8 is one zero-byte advance of the register, invertible (the
// polynomial's constant term is 1), so it has negative powers too. And
//     CRC32C(M) = state(M) ^ A8^n (0xFFFFFFFF) ^ 0xFFFFFFFF
// for an n-byte M (the affine constant of crc32c_jax.py:84 and :124).
// Zero bytes in front of a message leave its zero-init state unchanged.
//
// Geometry (ops/crc32c_cuda.py span_layout, tile_count, pick_span). A row
// is cut into m = ceil(n / S) spans of S bytes (S = 64..512, a power of
// two the wrapper picks), aligned to the END of the row, so only span 0
// can be short and it acts as a full span with leading zeros. The spans
// are padded in front to P = 2^levels slots with zero states. A tile is
// 1024 slots: 1024 / P whole rows when P <= 1024, else one of Q = P / 1024
// consecutive pieces of a row. Thread i of the tile's block computes the
// state of slot i (woven, below, its share of its warp's 32 slots), and
// the advance it needs to its row's end, A8^(S (P - 1 - slot)), splits
// into an operator of the thread's lane, A8^(S k1) with k1 < 32, one of
// its warp, A8^(32 S k2), and, past 1024 slots, one of its tile,
// A8^(1024 S k3): 97 operators in all, built on the host for each S
// (fold_tables) and independent of n.
//
// Stage 1 (crc32c_tiles): a persistent grid, one block of 1024 threads on
// each SM, walks the tiles. Lookups: slicing-by-4, per 4 bytes one lookup
// in each of four 256-entry tables (table k is table 0 advanced by k zero
// bytes). Each table lives in shared memory 32 times over, one copy per
// lane, entry e of table k for lane l at word (k 256 + e) 32 + l: a lane
// only ever reads its own bank, so lookups whose indices are data never
// meet in a bank (128 KiB of dynamic shared memory). Loads, in one of two
// layouts (woven_layout):
// - woven, where a warp's 32 spans lie in one row and n, the rows'
//   addresses and the stride are multiples of 4 (bench.py's rows): the
//   warp reads its 32 spans as one region of 32 S bytes, lane l the
//   4-byte units l, l + 32, l + 64, ..., so each warp load is 128
//   adjacent bytes. The tables the block fills are then advanced further
//   over the 31 units of the other lanes that follow each unit
//   (woven_tables: A8^124 after each), which costs no lookup, and the
//   lane's operator undoes the advance past its last unit, less the
//   units of the lanes after it: A8^(-4 l), an inverse power
//   (fold_tables(S, 4)). Units of a row's first region that lie before
//   the row read as zeros.
// - contiguous, for other rows: each thread reads its slot's span, a full
//   span on a 16-byte boundary as 16-byte loads and any other (the short
//   span 0, rows off a boundary) as a head of up to 15 bytes and a tail
//   through table 0 with 16-byte loads between. 32 lanes then load 16
//   bytes each from 32 spans S bytes apart, 32 lines a load, which the
//   split (chip_smoke.split_crc32c) times slower than the woven loads.
// Both stream 64 bytes a lane ahead of the lookups; the first tile's
// loads go out before the block fills its tables, and each next tile's
// before the fold. The fold: each lane applies its operator (32 columns
// in shared memory, stored so that lanes with distinct operators read
// distinct banks), the warp XORs its states by shuffles, and past 32
// slots warp 0 does the same with the 32 warp states, behind one
// __syncthreads a tile. A tile of whole rows writes their CRCs, XORed
// with the affine constant and 0xFFFFFFFF; a piece of a longer row
// writes one partial state.
// Stage 2 (crc32c_carry), only for rows of more than 1024 spans: a warp a
// row folds the row's Q partials 32 at a time, carrying the chunks left to
// right (acc = A8^(32 1024 S)(acc) ^ chunk), and writes the CRC. It is
// launched as stage 1's programmatic dependent, so its blocks load their
// operators while stage 1 runs.
//
// What bounds it: HBM bytes. At (64, 1 MiB), the shape bench.py times,
// 64 MiB in and a word per row out take 20.0 us at 3.35 TB/s. Per 4 input
// bytes a thread issues 4 conflict-free shared loads and about 10 INT32
// operations (a shift and a LOP3 that masks the byte and ORs in the lane's
// bank per lookup, two LOP3 that XOR); an SM serves 32 lookups and 64
// INT32 lanes a clock, so the lookups alone run at about 8 TB/s over 132
// SMs and the INT32 work at about 6 TB/s, both above the memory's rate.
// The kernel this one replaced (commit 1db9ba1) kept one copy of eight
// tables, so its 32 lanes met in banks at random, and read each span
// contiguously; it ran at a third of the byte bound. What is left at that
// shape is a fixed cost of each launch (the ramp of the first loads, the
// last chunk's lookups and the fold after the last load, stage 2), which
// a PyTorch reduction that reads the same bytes pays too. The split
// (swtpu_crc32c_split) runs variants that time the parts apart: lookups
// from one constant address (no index arithmetic), the loads alone, no
// fold, and slicing-by-8 over 16 copies of 8 tables (two lanes to a
// bank), which is slower.

#include <cuda_runtime.h>
#include <stdint.h>

// a stage-1 block's dynamic shared memory: the replicated tables, the lane
// and warp operators, the warp states
extern __shared__ __align__(16) unsigned char smem[];

namespace {

constexpr int kTile = 1024;        // a stage-1 block's threads, a tile's slots
constexpr int kTileLevels = 10;    // log2(kTile)
constexpr int kWarps = kTile / 32;
constexpr int kTableBytes = 128 << 10;        // the replicated tables
constexpr int kOpWords = 32 * 32;             // 32 operators, transposed
constexpr int kSmemBytes = kTableBytes + (2 * kOpWords + 2 * kWarps) * 4;
constexpr int kMaxLevels = 40;
constexpr int kCarryRows = 8;      // rows (warps) of a stage-2 block

// stage-1 variants; the wrapper runs kFull, the split the others
enum Mode { kFull = 0, kConstLookup = 1, kLoadsOnly = 2 };

// slicing-by-kSlice tables, each kCopies times over, entry by entry
template <int kSlice>
struct Layout {
  static constexpr int kCopies = 128 / kSlice;            // 32 or 16
  static constexpr int kEntryShift = kSlice == 4 ? 7 : 6;  // log2(entry bytes)
  static constexpr uint32_t kMask = 0xffu << kEntryShift;
  static constexpr int kBytes = 256 << kEntryShift;        // one table
};

// byte offset in table 0 of the entry for byte kByte of c, in this lane's
// copy (lane_off = (lane % kCopies) * 4 sits below the entry's bits)
template <int kSlice, int kByte>
__device__ __forceinline__ uint32_t entry(uint32_t c, uint32_t lane_off) {
  constexpr int sh = 8 * kByte - Layout<kSlice>::kEntryShift;
  uint32_t x;
  if constexpr (sh >= 0) {
    x = c >> sh;
  } else {
    x = c << -sh;
  }
  return (x & Layout<kSlice>::kMask) | lane_off;
}

template <int kSlice, int kMode, int kTable>
__device__ __forceinline__ uint32_t lookup(uint32_t off, uint32_t lane_off) {
  constexpr int base = kTable * Layout<kSlice>::kBytes;
  if constexpr (kMode == kConstLookup) {
    return *reinterpret_cast<volatile const uint32_t*>(smem + base + lane_off);
  } else {
    return *reinterpret_cast<const uint32_t*>(smem + base + off);
  }
}

// slicing-by-4 over c = crc ^ (4 bytes, little endian)
template <int kMode>
__device__ __forceinline__ uint32_t step4(uint32_t c, uint32_t lo) {
  uint32_t r = lookup<4, kMode, 3>(entry<4, 0>(c, lo), lo) ^
               lookup<4, kMode, 2>(entry<4, 1>(c, lo), lo) ^
               lookup<4, kMode, 1>(entry<4, 2>(c, lo), lo) ^
               lookup<4, kMode, 0>(entry<4, 3>(c, lo), lo);
  if constexpr (kMode == kConstLookup) r ^= c;  // keep the data live
  return r;
}

// slicing-by-8 over c = crc ^ (first 4 bytes) and hi (next 4)
template <int kMode>
__device__ __forceinline__ uint32_t step8(uint32_t c, uint32_t hi,
                                          uint32_t lo) {
  uint32_t r = lookup<8, kMode, 7>(entry<8, 0>(c, lo), lo) ^
               lookup<8, kMode, 6>(entry<8, 1>(c, lo), lo) ^
               lookup<8, kMode, 5>(entry<8, 2>(c, lo), lo) ^
               lookup<8, kMode, 4>(entry<8, 3>(c, lo), lo) ^
               lookup<8, kMode, 3>(entry<8, 0>(hi, lo), lo) ^
               lookup<8, kMode, 2>(entry<8, 1>(hi, lo), lo) ^
               lookup<8, kMode, 1>(entry<8, 2>(hi, lo), lo) ^
               lookup<8, kMode, 0>(entry<8, 3>(hi, lo), lo);
  if constexpr (kMode == kConstLookup) r ^= c ^ hi;
  return r;
}

template <int kSlice, int kMode>
__device__ __forceinline__ uint32_t step16(uint32_t crc, uint4 w,
                                           uint32_t lo) {
  if constexpr (kMode == kLoadsOnly) {
    return crc ^ w.x ^ w.y ^ w.z ^ w.w;
  } else if constexpr (kSlice == 4) {
    crc = step4<kMode>(crc ^ w.x, lo);
    crc = step4<kMode>(crc ^ w.y, lo);
    crc = step4<kMode>(crc ^ w.z, lo);
    return step4<kMode>(crc ^ w.w, lo);
  } else {
    crc = step8<kMode>(crc ^ w.x, w.y, lo);
    return step8<kMode>(crc ^ w.z, w.w, lo);
  }
}

// one byte through table 0
template <int kSlice, int kMode>
__device__ __forceinline__ uint32_t step1(uint32_t crc, uint32_t b,
                                          uint32_t lo) {
  if constexpr (kMode == kLoadsOnly) return crc ^ b;
  const uint32_t c = crc ^ b;
  uint32_t r = (crc >> 8) ^ lookup<kSlice, kMode, 0>(entry<kSlice, 0>(c, lo),
                                                      lo);
  if constexpr (kMode == kConstLookup) r ^= c;
  return r;
}

// where a thread's bytes of a tile lie
struct Work {
  const uint8_t* p;  // contiguous: the span's first byte; woven: the
                     // lane's unit 0, which may lie before the row
  int len;           // bytes to read (0: a zero slot, or past the last row)
  int skip;          // woven: the lane's first units, which lie before the
                     // row and read as zeros
  bool edge;         // woven: the warp's region starts before the row
};

// the bytes of thread tid in a tile. Contiguous: its slot's span. Woven:
// the warp's 32 spans as one region of 32 S bytes, of which lane l reads
// the kSlice-byte units l, l + 32, l + 64, ...
template <int kSlice>
__device__ __forceinline__ Work locate(long long tile, int tid, bool woven,
                                       const uint8_t* data, long long stride,
                                       long long rows, long long n,
                                       int span_shift, long long m,
                                       int levels) {
  long long row, slot;
  if (levels <= kTileLevels) {
    row = (tile << (kTileLevels - levels)) + (tid >> levels);
    slot = tid & ((1 << levels) - 1);
  } else {
    row = tile >> (levels - kTileLevels);
    slot = ((tile & ((1LL << (levels - kTileLevels)) - 1)) << kTileLevels) |
           tid;
  }
  const long long s = slot - ((1LL << levels) - m);
  Work w{data, 0, 0, false};
  if (row >= rows) return w;
  const int lane = tid & 31;
  if (woven) {
    const long long first = n - ((m - (s - lane)) << span_shift);
    if (first + (32LL << span_shift) <= 0) return w;
    w.p = data + row * stride + first + lane * kSlice;
    w.len = 1 << span_shift;
    if (first < 0) {
      const long long before = -first / kSlice;  // the region's units
      w.skip = before > lane ? static_cast<int>((before - lane + 31) / 32)
                             : 0;
      w.edge = true;
    }
  } else if (s >= 0) {
    const long long end = n - ((m - 1 - s) << span_shift);
    const long long begin = end > (1LL << span_shift)
                                ? end - (1LL << span_shift) : 0;
    w.p = data + row * stride + begin;
    w.len = static_cast<int>(end - begin);
  }
  return w;
}

// chunk i (64 bytes) of a thread's bytes into c: contiguous, four 16-byte
// loads; woven, 64 / kSlice units 32 units apart, each warp load 32
// adjacent units (coalesced), those before the row (kGuard) zero
template <int kSlice, bool kGuard>
__device__ __forceinline__ void load_chunk(uint4 (&c)[4], bool woven,
                                           const uint8_t* p, int i,
                                           int skip) {
  if (!woven) {
    const uint4* v = reinterpret_cast<const uint4*>(p) + 4 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = __ldg(v + j);
  } else if constexpr (kSlice == 4) {
    const uint32_t* v = reinterpret_cast<const uint32_t*>(p);
    uint32_t u[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int t = 16 * i + j;
      u[j] = !kGuard || t >= skip ? __ldg(v + 32 * t) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = make_uint4(u[4 * j], u[4 * j + 1], u[4 * j + 2], u[4 * j + 3]);
    }
  } else {
    const uint2* v = reinterpret_cast<const uint2*>(p);
    uint2 u[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = 8 * i + j;
      u[j] = !kGuard || t >= skip ? __ldg(v + 32 * t) : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = make_uint4(u[2 * j].x, u[2 * j].y, u[2 * j + 1].x,
                        u[2 * j + 1].y);
    }
  }
}

// a full span (contiguous, on a 16-byte boundary) or a lane's units
// (woven): chunks of 64 bytes, the next chunk's loads in flight while this
// one's lookups run; cur holds chunk 0. The lookups are the same in both:
// woven, the tables advance each unit's state over the 31 units of the
// other lanes that follow it
template <int kSlice, int kMode, bool kGuard>
__device__ __forceinline__ uint32_t full_span(bool woven, const uint8_t* p,
                                              int chunks, uint4 (&cur)[4],
                                              uint32_t lo, int skip) {
  uint32_t crc = 0;
  for (int i = 1; i < chunks; ++i) {
    uint4 nxt[4];
    load_chunk<kSlice, kGuard>(nxt, woven, p, i, skip);
#pragma unroll
    for (int j = 0; j < 4; ++j) crc = step16<kSlice, kMode>(crc, cur[j], lo);
#pragma unroll
    for (int j = 0; j < 4; ++j) cur[j] = nxt[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) crc = step16<kSlice, kMode>(crc, cur[j], lo);
  return crc;
}

// any other span (contiguous only): a head to the next 16-byte boundary,
// 16-byte loads, a tail
template <int kSlice, int kMode>
__device__ uint32_t any_span(const uint8_t* src, int len, uint32_t lo) {
  uint32_t crc = 0;
  int head = (16 - static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15)) &
             15;
  if (head > len) head = len;
  for (int i = 0; i < head; ++i) crc = step1<kSlice, kMode>(crc, src[i], lo);
  const uint4* v = reinterpret_cast<const uint4*>(src + head);
  const int words = (len - head) >> 4;
  for (int i = 0; i < words; ++i) {
    crc = step16<kSlice, kMode>(crc, __ldg(v + i), lo);
  }
  for (int i = head + 16 * words; i < len; ++i) {
    crc = step1<kSlice, kMode>(crc, src[i], lo);
  }
  return crc;
}

// a GF(2) operator applied to v; column b of operator k at opT[b 32 + k]
__device__ __forceinline__ uint32_t apply_op(const uint32_t* opT, int k,
                                             uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) r ^= opT[b * 32 + k] & (0u - ((v >> b) & 1u));
  return r;
}

__device__ __forceinline__ bool is_full(Work w, bool woven, int span) {
  return woven ? w.len > 0
               : w.len == span &&
                     (reinterpret_cast<uintptr_t>(w.p) & 15) == 0;
}

template <int kSlice, int kMode, bool kFold>
__global__ void __launch_bounds__(kTile, 1)
crc32c_tiles(const uint8_t* __restrict__ data, long long stride,
             long long rows, long long n, int span_shift, long long m,
             int levels, long long tiles, bool woven,
             const uint32_t* __restrict__ tables,
             const uint32_t* __restrict__ ops, uint32_t fin,
             uint32_t* __restrict__ partial, long long* __restrict__ out) {
  uint32_t* op1 = reinterpret_cast<uint32_t*>(smem + kTableBytes);
  uint32_t* op2 = op1 + kOpWords;
  uint32_t* st = op2 + kOpWords;  // [2][kWarps]: warp states, by tile parity
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int span = 1 << span_shift;
  const uint32_t lo = (lane % Layout<kSlice>::kCopies) * 4;

  // the first tile's loads go out before the tables are filled
  long long tile = blockIdx.x;
  Work w = locate<kSlice>(tile, tid, woven, data, stride, rows, n,
                          span_shift, m, levels);
  bool full = is_full(w, woven, span);
  uint4 cur[4];
  if (full) load_chunk<kSlice, true>(cur, woven, w.p, 0, w.skip);

  // the tables, each entry kCopies times over (16-byte stores of one
  // word), and the lane and warp operators
  constexpr int kVecs = Layout<kSlice>::kCopies / 4;
  uint4* dst = reinterpret_cast<uint4*>(smem);
#pragma unroll
  for (int i = tid; i < kTableBytes / 16; i += kTile) {
    const uint32_t v = __ldg(tables + i / kVecs);
    dst[i] = make_uint4(v, v, v, v);
  }
  for (int i = tid; i < 2 * kOpWords; i += kTile) op1[i] = __ldg(ops + i);
  __syncthreads();
  // stage 2 may start its prologue now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");

  // lane operator k1 over the lanes of a row (g1 of them), warp operator
  // k2 over its warps (g2)
  const int g1 = levels < 5 ? 1 << levels : 32;
  const int k1 = (g1 - 1) - (lane & (g1 - 1));
  const int g2 = levels <= 5 ? 1 : (levels < kTileLevels ? 1 << (levels - 5)
                                                          : kWarps);
  const int k2 = (g2 - 1) - (lane & (g2 - 1));
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    uint32_t crc = 0;
    if (full) {
      crc = w.edge ? full_span<kSlice, kMode, true>(woven, w.p, span >> 6,
                                                    cur, lo, w.skip)
                   : full_span<kSlice, kMode, false>(woven, w.p, span >> 6,
                                                     cur, lo, 0);
    } else if (w.len > 0) {
      crc = any_span<kSlice, kMode>(w.p, w.len, lo);
    }
    const long long done = tile;
    // the next tile's first loads go out before the fold
    if (tile + gridDim.x < tiles) {
      w = locate<kSlice>(tile + gridDim.x, tid, woven, data, stride, rows, n,
                         span_shift, m, levels);
      full = is_full(w, woven, span);
      if (full) load_chunk<kSlice, true>(cur, woven, w.p, 0, w.skip);
    }
    uint32_t v = kFold ? apply_op(op1, k1, crc) : crc;
    for (int o = 1; o < g1; o <<= 1) v ^= __shfl_xor_sync(0xffffffffu, v, o);
    if (levels <= 5) {
      const long long row = (done << (kTileLevels - levels)) + (tid >> levels);
      if ((lane & (g1 - 1)) == 0 && row < rows) {
        out[row] = static_cast<long long>(v ^ fin);
      }
      continue;
    }
    uint32_t* sb = st + kWarps * (it & 1);
    if (lane == 0) sb[warp] = v;
    __syncthreads();
    if (warp == 0) {
      uint32_t u = sb[lane];
      if (kFold) u = apply_op(op2, k2, u);
      for (int o = 1; o < g2; o <<= 1) {
        u ^= __shfl_xor_sync(0xffffffffu, u, o);
      }
      if ((lane & (g2 - 1)) == 0) {
        if (levels <= kTileLevels) {
          const long long row = (done << (kTileLevels - levels)) +
                                (lane >> (levels - 5));
          if (row < rows) out[row] = static_cast<long long>(u ^ fin);
        } else {
          partial[done] = u;  // tiles of a row are consecutive
        }
      }
    }
  }
}

__global__ void __launch_bounds__(32 * kCarryRows)
crc32c_carry(const uint32_t* __restrict__ partial, long long rows,
             int q_levels, const uint32_t* __restrict__ ops3, uint32_t fin,
             long long* __restrict__ out) {
  // A8^(1024 S k) for k < 32, transposed, then A8^(32 1024 S)
  __shared__ uint32_t op[kOpWords + 32];
  for (int i = threadIdx.x; i < kOpWords + 32; i += blockDim.x) {
    op[i] = ops3[i];
  }
  __syncthreads();
  // launched as stage 1's dependent: the partials are stage 1's, so wait
  // for its grid to finish (at once when there is no such grid)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kCarryRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long q = 1LL << q_levels;
  const uint32_t* src = partial + row * q;
  const int g = q_levels < 5 ? 1 << q_levels : 32;
  const int k = (g - 1) - (lane & (g - 1));
  uint32_t acc = 0;
  for (long long c = 0; c < q; c += 32) {
    uint32_t v = apply_op(op, k, lane < g ? src[c + lane] : 0u);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) v ^= __shfl_xor_sync(0xffffffffu, v, o);
    uint32_t r = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      r ^= op[kOpWords + b] & (0u - ((acc >> b) & 1u));
    }
    acc = r ^ v;
  }
  if (lane == 0) out[row] = static_cast<long long>(acc ^ fin);
}

template <int kSlice, int kMode, bool kFold>
int launch(const void* data, long long stride, long long rows, long long n,
           int span, int blocks, int woven, const void* tables,
           const void* ops, unsigned int aff, void* partial, void* out,
           void* stream, int stages) {
  if (rows < 0 || n < 1 || span < 64 || span > 4096 ||
      (span & (span - 1)) != 0 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  int span_shift = 0;
  while ((1 << span_shift) < span) ++span_shift;
  const long long m = (n + span - 1) >> span_shift;
  int levels = 0;
  while ((1LL << levels) < m) ++levels;
  if (levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  // woven: a warp's region within one row, every unit whole and aligned
  if (woven && (levels < 5 || n % kSlice != 0 ||
                reinterpret_cast<uintptr_t>(data) % kSlice != 0 ||
                (rows > 1 && stride % kSlice != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles =
      levels <= kTileLevels
          ? (rows + (kTile >> levels) - 1) >> (kTileLevels - levels)
          : rows << (levels - kTileLevels);
  const long long carry_blocks = (rows + kCarryRows - 1) / kCarryRows;
  if (carry_blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t fin = aff ^ 0xFFFFFFFFu;
  const uint32_t* op = static_cast<const uint32_t*>(ops);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages & 1) {
    cudaError_t err = cudaFuncSetAttribute(
        crc32c_tiles<kSlice, kMode, kFold>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned grid =
        static_cast<unsigned>(tiles < blocks ? tiles : blocks);
    crc32c_tiles<kSlice, kMode, kFold><<<grid, kTile, kSmemBytes, s>>>(
        static_cast<const uint8_t*>(data), stride, rows, n, span_shift, m,
        levels, tiles, woven != 0, static_cast<const uint32_t*>(tables), op,
        fin, static_cast<uint32_t*>(partial), static_cast<long long*>(out));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((stages & 2) && levels > kTileLevels) {
    // a programmatic dependent launch: its blocks load their operators
    // while stage 1 runs, which hides the second launch's latency
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(carry_blocks));
    cfg.blockDim = dim3(32 * kCarryRows);
    cfg.stream = s;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, crc32c_carry, static_cast<const uint32_t*>(partial), rows,
        levels - kTileLevels, op + 2 * kOpWords, fin,
        static_cast<long long*>(out));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

// CRC32C of `rows` rows of n bytes, row r at data + r * stride, into
// out[r] (int64), in spans of `span` bytes on a grid of at most `blocks`
// blocks (one an SM), the warps' regions woven or not (ops/crc32c_cuda.py
// woven_layout). tables: the slicing tables (8 x 256), or for the woven
// layout the woven ones (woven_tables); ops: the fold operators for `span`
// and the layout, transposed (fold_words); aff = A8^n(0xFFFFFFFF);
// partial: one word a tile of scratch when a row has more than 1024
// spans. Launches one or two kernels on `stream` and returns the first
// CUDA error, or 0.
extern "C" int swtpu_crc32c_batch(const void* data, long long stride,
                                  long long rows, long long n, int span,
                                  int blocks, int woven, const void* tables,
                                  const void* ops, unsigned int aff,
                                  void* partial, void* out, void* stream) {
  return launch<4, kFull, true>(data, stride, rows, n, span, blocks, woven,
                                tables, ops, aff, partial, out, stream, 3);
}

// The kernel's variants, for timing its parts apart (chip_smoke.py
// split_crc32c): 0 the kernel; 1 lookups from one constant address per
// table (no index arithmetic); 2 the loads alone; 3 no fold (states XORed
// without their operators); 4 slicing-by-8 over 16 copies of 8 tables
// (its tables and operators those of 8-byte units). Only variants 0 and 4
// compute the CRC. stages: 1 stage 1 alone, 2 stage 2 alone, 3 both. The
// other arguments as swtpu_crc32c_batch's.
extern "C" int swtpu_crc32c_split(int variant, int stages, const void* data,
                                  long long stride, long long rows,
                                  long long n, int span, int blocks,
                                  int woven, const void* tables,
                                  const void* ops, unsigned int aff,
                                  void* partial, void* out, void* stream) {
#define SWTPU_CRC32C_VARIANT(slice, mode, fold)                            \
  launch<slice, mode, fold>(data, stride, rows, n, span, blocks, woven,    \
                            tables, ops, aff, partial, out, stream, stages)
  switch (variant) {
    case 0:
      return SWTPU_CRC32C_VARIANT(4, kFull, true);
    case 1:
      return SWTPU_CRC32C_VARIANT(4, kConstLookup, true);
    case 2:
      return SWTPU_CRC32C_VARIANT(4, kLoadsOnly, true);
    case 3:
      return SWTPU_CRC32C_VARIANT(4, kFull, false);
    case 4:
      return SWTPU_CRC32C_VARIANT(8, kFull, true);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SWTPU_CRC32C_VARIANT
}

// dynamic shared memory of a stage-1 block, in bytes
extern "C" int swtpu_crc32c_smem_bytes() { return kSmemBytes; }
