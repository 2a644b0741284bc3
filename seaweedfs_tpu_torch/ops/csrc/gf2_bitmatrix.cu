// GF(256) shard transform as a GF(2) bit-matrix product on Hopper (sm_90a):
// one fused kernel that turns the input bytes into int8 tensor-core
// fragments in registers, multiplies them with wgmma and packs the low bits
// of the sums into output bytes in its epilogue.
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
// is zero blocks. Here every byte column is one row of the product's A
// operand (its 8 k input bits), B is M's transpose with its rows and columns
// permuted (below), and D = A B is exact in int32: a sum is at most 8 k, so
// it fits its low byte, whose bit 0 is the output bit.
//
// What bounds it: the function moves (k + rows) bytes a column, at the
// pipeline block (8, 10, 1 MiB), rows = 4, 117 MB, 35 us at 3.35 TB/s, and
// its products need 22 us at the dense int8 peak (26 us with K padded to
// 96). The unfused form this kernel replaced wrote the planes (8 k bytes a
// column) and the int32 sums (32 rows bytes) to HBM and read them back, 30x
// the function's bytes; here they never leave the SM. What is left is SM
// work: the transpose and the fragments on the INT32 pipe, and three
// m64n32k32 wgmmas per 64 columns whose issue and wait do not hide behind
// the integer work of the other warps (chip_smoke.py phase 5 prints the
// time beside the bound).
//
// Design. A persistent grid of one-warpgroup blocks (128 threads) walks the
// (window, tile of 512 columns) pairs; warp w owns columns w*128 .. w*128 +
// 127 of a tile and moves them alone, so the warps of a block meet only in
// the products. Each block:
//  1. places B once in shared memory, in the no-swizzle K-major layout the
//     wgmma descriptor reads: core matrices of 8 N x 16 K bytes, the core of
//     K chunk c (16 K) and N group n at (c * NG + n) * 128, NG = 4 NI; the
//     next N group is 128 bytes on (the descriptor's stride byte offset),
//     the next K chunk NG * 128 bytes on (its leading byte offset);
//  2. copies the next tile's k input rows into the other of two buffers
//     while it works on this one: cp.async 16-byte copies when the tile is
//     whole and its rows and stride are 16-byte aligned, byte copies
//     otherwise (x may be strided along its first two axes and its rows need
//     not be aligned);
//  3. transposes its columns: lane l turns 4 columns x 4 inputs into one
//     word per column (8 __byte_perm) and stores each column's 16 input
//     bytes as one 16-byte word (slot() spreads them over the banks);
//  4. per sub-tile of 16 columns a warp, builds the A fragments. In the
//     m64nNk32 int8 A layout lane (g = lane / 4, tig = lane % 4) of warp w
//     holds rows w*16 + g (registers 0, 2) and w*16 + g + 8 (1, 3), at
//     K = tig*4 + e (registers 0, 1) and 16 + tig*4 + e (2, 3). The kernel
//     gives row w*16 + g + 8h the column 2g + h of the warp's sub-tile, and
//     K = 16 h2 + 4 tk + e of step s the bit tk + 4 h2 of input 4 s + e, so
//     a register is (column word >> bit) & 0x01010101: two operations;
//  5. issues one wgmma.m64n32k32.s32.s8.s8 (A in registers, B through the
//     descriptor) per k32 step and per block of 4 output rows, and waits;
//  6. epilogue: N = 8 jj + 2 t + ee of block q is bit 2 jj + ee of output row
//     4 q + t, so accumulator d[4 jj + 2 h + ee] of lane tig is bit
//     2 jj + ee of row 4 q + tig at the lane's column h: a lane holds both
//     its columns' whole bytes of one row, and no lane waits for another.
//     The low bytes of four sums go into one word by multiply-adds, bit 0
//     of each is masked, and one multiply gathers the eight bits into the
//     top byte; the two columns' bytes are stored as 2 bytes into the raw
//     buffer's output rows, which go out as 16-byte stores (byte stores at
//     a ragged or unaligned tail).
// Templates: KS = ceil(k / 4) k32 steps, NI = ceil(rows / 4) blocks of 4
// output rows; padded inputs meet zero rows of B and padded rows are not
// stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxRows = 16;
constexpr int kTile = 512;               // columns per tile
constexpr int kThreads = 128;            // one warpgroup
constexpr int kOwn = kTile / 4;          // columns a warp owns per tile
constexpr int kSubTiles = kOwn / 16;     // sub-tiles of 16 columns a warp
// raw row stride: 16 bytes more than a tile, so that the epilogue's 2-byte
// stores to 4 output rows start 4 banks apart
constexpr int kStride = kTile + 16;

// column c's 16-byte word of the transposed tile: a permutation inside each
// group of 8 columns, so that the transpose's 16-byte stores (8 lanes a
// phase, 4 columns apart) hit 8 distinct bank groups
__device__ __forceinline__ int slot(int c) {
  return (c & ~7) | ((c + (c >> 3)) & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// matrix descriptor of a no-swizzle operand in shared memory: address,
// leading byte offset (next core matrix along K) and stride byte offset
// (next core matrix along N), each in 16-byte units
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

// d = A B (+ d when accumulate) for one m64n32k32 int8 step, A (4
// registers) from registers, B from shared memory through its descriptor
__device__ __forceinline__ void mma32(int32_t* d, const uint32_t* a,
                                      uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// KS k32 steps; NI blocks of 4 output rows (N = 32) per step
template <int KS, int NI>
__global__ void __launch_bounds__(kThreads)
gf2_bitmatrix_kernel(const uint8_t* __restrict__ x, int k, long long x_sb,
                     long long x_sk, long long length, long long tiles,
                     long long total, const int8_t* __restrict__ bitmat,
                     int rows, uint8_t* __restrict__ out, long long o_sb,
                     long long o_sr) {
  constexpr int kNG = 4 * NI;        // N groups of 8 = padded output rows
  // a raw buffer holds the tile's input rows (rows k .. 4 KS - 1 are never
  // written: B is zero there) and then, once a warp has transposed its
  // columns, that warp's output rows
  constexpr int kRows = 4 * KS > kNG ? 4 * KS : kNG;
  __shared__ __align__(128) uint8_t b_s[KS * 2 * kNG * 128];
  __shared__ __align__(16) uint8_t raw_s[2][kRows * kStride];
  __shared__ __align__(16) uint8_t tr_s[kTile * 16];

  // 1. B[K][n] of step s, block q: K = 16 h2 + 4 tk + e is bit tk + 4 h2 of
  // input 4 s + e, n = 8 jj + 2 t + ee is bit 2 jj + ee of output row
  // 4 q + t; zero past k inputs and rows output rows
  const int kb = 8 * k;
  for (int idx = threadIdx.x; idx < KS * 2 * kNG * 128; idx += kThreads) {
    const int core = idx >> 7;
    const int chunk = core / kNG;      // K chunk: step chunk / 2, h2 chunk & 1
    const int ng = core - chunk * kNG;
    const int kk = idx & 15;
    const int n = (ng & 3) * 8 + ((idx >> 4) & 7);   // within block ng / 4
    const int input = 4 * (chunk >> 1) + (kk & 3);
    const int bit = (kk >> 2) + 4 * (chunk & 1);
    const int r = 4 * (ng >> 2) + ((n >> 1) & 3);
    const int out_bit = 2 * (n >> 3) + (n & 1);
    b_s[idx] = (r < rows && input < k)
                   ? bitmat[(r * 8 + out_bit) * kb + input * 8 + bit]
                   : 0;
  }
  // wgmma reads B through the async proxy, once every thread placed its part
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int first = warp * kOwn;       // the warp's first column of a tile
  const uint64_t desc0 = make_desc(smem_addr(b_s), kNG * 128, 128);

  auto span = [&](long long tile, long long& bi, long long& t0) {
    bi = tile / tiles;
    t0 = (tile - bi * tiles) * kTile;
    return static_cast<int>(length - t0 < kTile ? length - t0 : kTile);
  };

  // the warp's columns of a tile's k input rows into dst
  auto load = [&](long long tile, uint8_t* dst) {
    long long bi, t0;
    const int n = span(tile, bi, t0);
    const uint8_t* src = x + bi * x_sb + t0;
    if (n == kTile && ((reinterpret_cast<uintptr_t>(src) |
                        static_cast<uintptr_t>(x_sk)) & 15) == 0) {
      for (int c = lane; c < k * (kOwn / 16); c += 32) {
        const int i = c / (kOwn / 16);
        const int col = first + 16 * (c - i * (kOwn / 16));
        cp_async16(dst + i * kStride + col, src + i * x_sk + col);
      }
    } else {
      for (int c = lane; c < k * kOwn; c += 32) {
        const int i = c / kOwn;
        const int col = first + c - i * kOwn;
        if (col < n) dst[i * kStride + col] = src[i * x_sk + col];
      }
    }
    cp_async_commit();
  };

  // the warp's columns of the tile's output rows from src
  auto store = [&](long long tile, const uint8_t* src) {
    long long bi, t0;
    const int n = span(tile, bi, t0);
    uint8_t* dst = out + bi * o_sb + t0;
    if (n == kTile && ((reinterpret_cast<uintptr_t>(dst) |
                        static_cast<uintptr_t>(o_sr)) & 15) == 0) {
      for (int c = lane; c < rows * (kOwn / 16); c += 32) {
        const int r = c / (kOwn / 16);
        const int col = first + 16 * (c - r * (kOwn / 16));
        *reinterpret_cast<uint4*>(dst + r * o_sr + col) =
            *reinterpret_cast<const uint4*>(src + r * kStride + col);
      }
    } else {
      for (int c = lane; c < rows * kOwn; c += 32) {
        const int r = c / kOwn;
        const int col = first + c - r * kOwn;
        if (col < n) dst[r * o_sr + col] = src[r * kStride + col];
      }
    }
  };

  long long tile = blockIdx.x;
  int buf = 0;
  if (tile < total) load(tile, raw_s[0]);
  for (; tile < total; tile += gridDim.x) {
    uint8_t* raw = raw_s[buf];
    cp_async_wait0();
    __syncwarp();
    if (tile + gridDim.x < total) load(tile + gridDim.x, raw_s[buf ^ 1]);

    // 3. transpose: lane l turns columns first + 4 l .. + 3 of the input
    // rows into one 16-byte word per column, byte i = input i
    {
      const int col = first + 4 * lane;
      const uint8_t* in = raw + col;
      uint32_t w[4][4] = {};             // [column][step]
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const uint32_t r0 = *reinterpret_cast<const uint32_t*>(
            in + (4 * s) * kStride);
        const uint32_t r1 = *reinterpret_cast<const uint32_t*>(
            in + (4 * s + 1) * kStride);
        const uint32_t r2 = *reinterpret_cast<const uint32_t*>(
            in + (4 * s + 2) * kStride);
        const uint32_t r3 = *reinterpret_cast<const uint32_t*>(
            in + (4 * s + 3) * kStride);
        const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
        const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
        const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
        const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
        w[0][s] = __byte_perm(lo01, lo23, 0x5410);
        w[1][s] = __byte_perm(lo01, lo23, 0x7632);
        w[2][s] = __byte_perm(hi01, hi23, 0x5410);
        w[3][s] = __byte_perm(hi01, hi23, 0x7632);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<uint4*>(tr_s + slot(col + c) * 16) =
            make_uint4(w[c][0], w[c][1], w[c][2], w[c][3]);
      }
    }
    __syncwarp();

#pragma unroll 1
    for (int sub = 0; sub < kSubTiles; ++sub) {
      // 4. row w*16 + g + 8h is column 2g + h of the warp's sub-tile;
      // register r holds bit tig + 4 (r >> 1) of inputs 4 s .. 4 s + 3
      const int col = first + sub * 16 + 2 * g;
      const uint4 c0 = *reinterpret_cast<const uint4*>(tr_s + slot(col) * 16);
      const uint4 c1 =
          *reinterpret_cast<const uint4*>(tr_s + slot(col + 1) * 16);
      const uint32_t w0[4] = {c0.x, c0.y, c0.z, c0.w};
      const uint32_t w1[4] = {c1.x, c1.y, c1.z, c1.w};
      uint32_t a[KS][4];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        a[s][0] = (w0[s] >> tig) & 0x01010101u;
        a[s][1] = (w1[s] >> tig) & 0x01010101u;
        a[s][2] = (w0[s] >> (tig + 4)) & 0x01010101u;
        a[s][3] = (w1[s] >> (tig + 4)) & 0x01010101u;
      }

      // 5. d = A B: the first step overwrites the accumulators
      int32_t d[NI][16];
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < KS; ++s) {
#pragma unroll
        for (int q = 0; q < NI; ++q) {
          mma32(d[q], a[s], desc0 + (((2 * s * kNG + 4 * q) * 128) >> 4),
                s > 0);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int q = 0; q < NI; ++q) {
#pragma unroll
        for (int e = 0; e < 16; ++e) asm volatile("" : "+r"(d[q][e]));
      }

      // 6. d[q][4 jj + 2 h + ee] is bit 2 jj + ee of output row 4 q + tig
      // at column h; each sum is under 256, bit 0 its parity
#pragma unroll
      for (int q = 0; q < NI; ++q) {
        uint32_t packed[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) v[e] = static_cast<uint32_t>(d[q][e]);
          // bits 0..3 at bit 0 of bytes 0..3, bits 4..7 at bit 4 of them
          const uint32_t lo = v[2 * h] + (v[2 * h + 1] << 8) +
                              (v[2 * h + 4] << 16) + (v[2 * h + 5] << 24);
          const uint32_t hi = (v[2 * h + 8] << 4) + (v[2 * h + 9] << 12) +
                              (v[2 * h + 12] << 20) + (v[2 * h + 13] << 28);
          // the multiply moves bit 8e to 24 + e and 8e + 4 to 28 + e; no two
          // of its partial products meet, so nothing carries
          packed[h] = ((lo & 0x01010101u) | (hi & 0x10101010u)) * 0x01020408u;
        }
        *reinterpret_cast<uint16_t*>(raw + (4 * q + tig) * kStride + col) =
            static_cast<uint16_t>(__byte_perm(packed[0], packed[1], 0x0073));
      }
    }
    __syncwarp();
    store(tile, raw);
    __syncwarp();
    buf ^= 1;
  }
}

// resident blocks per SM of an instance (0 if the query failed); the
// carveout asks for the most shared memory, which the tiles need
template <int KS, int NI>
int blocks_per_sm() {
  static int cached = 0;
  if (cached == 0) {
    cudaFuncSetAttribute(gf2_bitmatrix_kernel<KS, NI>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, gf2_bitmatrix_kernel<KS, NI>, kThreads, 0) != cudaSuccess) {
      return 0;
    }
    cached = n;
  }
  return cached;
}

template <int KS, int NI>
int launch(const uint8_t* x, int k, long long x_sb, long long x_sk,
           long long batch, long long length, const int8_t* bitmat,
           int rows, uint8_t* out, long long o_sb, long long o_sr,
           cudaStream_t stream) {
  const int per_sm = blocks_per_sm<KS, NI>();
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (length + kTile - 1) / kTile;
  const long long total = batch * tiles;
  const long long wave = static_cast<long long>(sms) * per_sm;
  const long long blocks = total < wave ? total : wave;
  gf2_bitmatrix_kernel<KS, NI>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          x, k, x_sb, x_sk, length, tiles, total, bitmat, rows, out, o_sb,
          o_sr);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch_rows(const uint8_t* x, int k, long long x_sb, long long x_sk,
                long long batch, long long length, const int8_t* bitmat,
                int rows, uint8_t* out, long long o_sb, long long o_sr,
                cudaStream_t stream) {
  switch ((rows + 3) / 4) {
    case 1:
      return launch<KS, 1>(x, k, x_sb, x_sk, batch, length, bitmat, rows,
                           out, o_sb, o_sr, stream);
    case 2:
      return launch<KS, 2>(x, k, x_sb, x_sk, batch, length, bitmat, rows,
                           out, o_sb, o_sr, stream);
    case 3:
      return launch<KS, 3>(x, k, x_sb, x_sk, batch, length, bitmat, rows,
                           out, o_sb, o_sr, stream);
    case 4:
      return launch<KS, 4>(x, k, x_sb, x_sk, batch, length, bitmat, rows,
                           out, o_sb, o_sr, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: (batch, k, length) uint8 with strides x_sb, x_sk, last axis
// contiguous; bitmat: the (8 rows, 8 k) int8 bit-matrix, row-major; out:
// (batch, rows, length) uint8 with strides o_sb, o_sr, last axis
// contiguous. Every pointer is a device pointer. Launches one kernel on
// `stream` and does not synchronise. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for shapes the kernel
// does not take.
extern "C" int swtpu_gf2_transform(const void* x, int k, long long x_sb,
                                   long long x_sk, long long batch,
                                   long long length, const void* bitmat,
                                   int rows, void* out, long long o_sb,
                                   long long o_sr, void* stream) {
  if (k < 1 || k > kMaxK || rows < 1 || rows > kMaxRows || batch < 0 ||
      length < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || length == 0) return 0;
  const uint8_t* xi = static_cast<const uint8_t*>(x);
  const int8_t* m = static_cast<const int8_t*>(bitmat);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((k + 3) / 4) {
    case 1:
      return launch_rows<1>(xi, k, x_sb, x_sk, batch, length, m, rows, o,
                            o_sb, o_sr, s);
    case 2:
      return launch_rows<2>(xi, k, x_sb, x_sk, batch, length, m, rows, o,
                            o_sb, o_sr, s);
    case 3:
      return launch_rows<3>(xi, k, x_sb, x_sk, batch, length, m, rows, o,
                            o_sb, o_sr, s);
    case 4:
      return launch_rows<4>(xi, k, x_sb, x_sk, batch, length, m, rows, o,
                            o_sb, o_sr, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
