// GF(256) shard transform as a GF(2) bit-matrix product on Hopper (sm_90a):
// the unpack and pack kernels around an int8 tensor-core product.
//
// Replaces seaweedfs_tpu/ops/gf256_mxu.py::_mxu_block (kernel K4, reached
// through ::mxu_words_transform with the matrix of ::_plane_matrix). It
// computes the K1 function, out[b, r] = XOR_i gf_mul(C[r, i], x[b, i]) for
// every byte column, as out_bits = M x in_bits (mod 2), M = gf.gf2_matrix(C)
// of shape (8 rows, 8 k): row r*8+b is output row r, bit b; column i*8+j is
// input i, bit j.
//
// Byte planes, not word planes. The TPU program multiplies a
// (32 rows, 32 k) matrix by the 32 bitplanes of each uint32 word; that
// matrix is block-diagonal over the word's 4 byte slots, so 3/4 of its work
// is zero blocks. Here every byte column n = (b, l) is one row of an
// (N, 8 k) int8 matrix of its input bits, and the product with the
// (8 k, 8 rows) transpose of M is taken per byte:
//   1. swtpu_gf2_unpack: planes[n, i*8 + j] = (x[b, i, l] >> j) & 1;
//   2. torch._int_mm in the wrapper: sums = planes @ M^T, int32, exact
//      (a sum is at most 8 k);
//   3. swtpu_gf2_pack: out[b, r, l] = OR_b' (sums[n, r*8 + b'] & 1) << b'.
// The wrapper cuts the block into chunks of (windows, positions) and runs
// the three steps per chunk; inside a chunk the plane rows run over
// (b - b0) * lc + (l - l0).
//
// What bounds it: HBM bytes, and not the function's. The function moves
// (k + rows) bytes per column; this unfused form writes and reads 8 k bytes
// of planes and 32 rows bytes of int32 sums per column besides (at k = 10,
// rows = 4 that is 30x the function's bytes), unless a chunk stays in the
// 50 MB L2. The product itself, 2 x 8 rows x 8 k int8 operations per
// column, needs 0.62 of the function's byte bound at 1,979 TOP/s. A fused
// kernel (unpack in the prologue, int8 mma, & 1 and pack in the epilogue)
// would keep planes and sums on chip; it is later work.
//
// Unpack: a block takes a tile of kTile columns of one window, loads the k
// input rows into shared memory (16-byte loads where the rows are 16-byte
// aligned and the tile is whole, byte loads otherwise), and writes the
// tile's plane rows, which are contiguous, as 16-byte stores of two
// spread bytes (8-byte stores at an odd start or end). A byte spreads to 8
// bytes of 0/1 with two multiplies and masks, no loop.
// Pack: a thread takes 16 columns of one output row, reads each column's 8
// sums with two 16-byte loads, and writes the 16 output bytes with one
// 16-byte store (byte stores on a ragged or unaligned tail).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxRows = 16;
constexpr int kTile = 256;            // columns per unpack block
constexpr int kTileStride = kTile + 16;  // smem row stride: spreads banks
constexpr int kThreads = 256;

// 8 bytes of 0/1, byte j = bit j of v (little-endian: .x holds bits 0-3).
// v * 0x01010101 copies v into every byte; the mask keeps bit j in byte j;
// adding 0x7F to a byte that is 0 or 1 << j sets its bit 7 exactly when it
// is not 0, with no carry out of the byte.
__device__ __forceinline__ uint2 spread(uint32_t v) {
  const uint32_t r = v * 0x01010101u;
  const uint32_t lo = r & 0x08040201u;
  const uint32_t hi = r & 0x80402010u;
  return make_uint2(((lo + 0x7F7F7F7Fu) >> 7) & 0x01010101u,
                    ((hi + 0x7F7F7F7Fu) >> 7) & 0x01010101u);
}

__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint8_t* __restrict__ x, int k, long long x_sb,
              long long x_sk, long long b0, long long l0, long long lc,
              long long tiles, int8_t* __restrict__ planes) {
  __shared__ __align__(16) uint8_t tile[kMaxK * kTileStride];
  const long long bi = blockIdx.x / tiles;
  const long long t0 = (blockIdx.x - bi * tiles) * kTile;
  const int n = static_cast<int>(lc - t0 < kTile ? lc - t0 : kTile);
  const uint8_t* src = x + (b0 + bi) * x_sb + l0 + t0;

  const bool vec = n == kTile &&
      ((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(x_sk)) &
       15) == 0;
  if (vec) {
    for (int c = threadIdx.x; c < k * (kTile / 16); c += kThreads) {
      const int i = c / (kTile / 16);
      const int q = c - i * (kTile / 16);
      *reinterpret_cast<uint4*>(tile + i * kTileStride + q * 16) =
          __ldg(reinterpret_cast<const uint4*>(src + i * x_sk + q * 16));
    }
  } else {
    for (int c = threadIdx.x; c < k * n; c += kThreads) {
      const int i = c / n;
      const int p = c - i * n;
      tile[i * kTileStride + p] = src[i * x_sk + p];
    }
  }
  __syncthreads();

  // plane row bi * lc + t0 onwards: n rows of k halves of 8 bytes
  const long long h0 = (bi * lc + t0) * k;  // first half, in 8-byte units
  uint2* dst = reinterpret_cast<uint2*>(planes) + h0;
  const int halves = n * k;
  const int lead = static_cast<int>(h0 & 1);  // an odd start: one uint2
  if (lead && threadIdx.x == 0) {
    dst[0] = spread(tile[0]);
  }
  const int pairs = (halves - lead) / 2;
  uint4* dst4 = reinterpret_cast<uint4*>(dst + lead);
  for (int q = threadIdx.x; q < pairs; q += kThreads) {
    const int h = lead + 2 * q;
    const int p0 = h / k, i0 = h - p0 * k;
    const int p1 = (h + 1) / k, i1 = h + 1 - p1 * k;
    const uint2 a = spread(tile[i0 * kTileStride + p0]);
    const uint2 b = spread(tile[i1 * kTileStride + p1]);
    dst4[q] = make_uint4(a.x, a.y, b.x, b.y);
  }
  if ((halves - lead) & 1) {
    if (threadIdx.x == 0) {
      const int h = halves - 1;
      const int p = h / k, i = h - p * k;
      dst[h] = spread(tile[i * kTileStride + p]);
    }
  }
}

// bits 0..7 of a byte from the low bit of 8 sums
__device__ __forceinline__ uint32_t parity_byte(int4 a, int4 b) {
  return (a.x & 1) | (a.y & 1) << 1 | (a.z & 1) << 2 | (a.w & 1) << 3 |
         (b.x & 1) << 4 | (b.y & 1) << 5 | (b.z & 1) << 6 | (b.w & 1) << 7;
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const int32_t* __restrict__ sums, int rows, long long b0,
            long long l0, long long lc, long long groups, long long total,
            uint8_t* __restrict__ out, long long o_sb, long long o_sr) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= total) return;
  // t -> (window bi, output row r, group g of 16 columns); g fastest, so a
  // warp's stores are neighbouring 16-byte chunks of one output row
  const long long per_window = rows * groups;
  const long long bi = t / per_window;
  const long long rem = t - bi * per_window;
  const int r = static_cast<int>(rem / groups);
  const long long g = rem - r * groups;
  const long long c0 = g * 16;
  const int n = static_cast<int>(lc - c0 < 16 ? lc - c0 : 16);
  const int4* row = reinterpret_cast<const int4*>(
      sums + ((bi * lc + c0) * rows + r) * 8);
  const long long step = rows * 2;  // int4s from one column's sums to next
  uint8_t* dst = out + (b0 + bi) * o_sb + r * o_sr + l0 + c0;

  if (n == 16 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t v = 0;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int4* s = row + (q * 4 + p) * step;
        v |= parity_byte(__ldg(s), __ldg(s + 1)) << (8 * p);
      }
      w[q] = v;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int p = 0; p < n; ++p) {
      const int4* s = row + p * step;
      dst[p] = static_cast<uint8_t>(parity_byte(__ldg(s), __ldg(s + 1)));
    }
  }
}

}  // namespace

// x: (B, k, L) uint8, strides x_sb, x_sk, last axis contiguous. Writes the
// plane rows of windows b0 .. b0 + nb - 1 and columns l0 .. l0 + lc - 1 to
// planes, (nb * lc, 8 k) int8 row-major. Returns cudaGetLastError().
extern "C" int swtpu_gf2_unpack(const void* x, int k, long long x_sb,
                                long long x_sk, long long b0, long long nb,
                                long long l0, long long lc, void* planes,
                                void* stream) {
  if (k < 1 || k > kMaxK || nb < 0 || lc < 0 || b0 < 0 || l0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0 || lc == 0) return 0;
  const long long tiles = (lc + kTile - 1) / kTile;
  const long long blocks = nb * tiles;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), k, x_sb, x_sk, b0, l0, lc, tiles,
      static_cast<int8_t*>(planes));
  return static_cast<int>(cudaGetLastError());
}

// sums: (nb * lc, 8 rows) int32 row-major, rows in the unpack's order.
// Writes out[b0 + bi, r, l0 + c] for bi < nb, c < lc; out is (B, rows, L)
// uint8 with strides o_sb, o_sr, last axis contiguous. Returns
// cudaGetLastError().
extern "C" int swtpu_gf2_pack(const void* sums, int rows, long long b0,
                              long long nb, long long l0, long long lc,
                              void* out, long long o_sb, long long o_sr,
                              void* stream) {
  if (rows < 1 || rows > kMaxRows || nb < 0 || lc < 0 || b0 < 0 ||
      l0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0 || lc == 0) return 0;
  const long long groups = (lc + 15) / 16;
  const long long total = nb * rows * groups;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  pack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sums), rows, b0, l0, lc, groups, total,
      static_cast<uint8_t*>(out), o_sb, o_sr);
  return static_cast<int>(cudaGetLastError());
}
