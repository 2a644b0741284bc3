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
// for a message split as S_0 || S_1,
//     state(S_0 || S_1) = A8^|S_1| (state(S_0)) ^ state(S_1),
// where A8 is one zero-byte advance of the register. And
//     CRC32C(M) = state(M) ^ A8^n (0xFFFFFFFF) ^ 0xFFFFFFFF
// for an n-byte M (the affine constant of crc32c_jax.py:84 and :124).
// Zero bytes in front of a message leave its zero-init state unchanged, so
// the segments are aligned to the END of the row: segment s of
// segs = ceil(n / 256) covers bytes [n - (segs - s) 256, n - (segs - 1 - s)
// 256), cut at 0, so only segment 0 can be short, and it acts as a full
// segment with leading zeros. The segment count is padded at the front to
// padded = 2^levels with zero states. Then every node at fold level j covers
// exactly 256 * 2^j bytes, and one operator per level, A8^(256 * 2^j) as 32
// uint32 columns (ops[j]), folds every pair: node = ops[j](left) ^ right.
// The wrapper builds ops and the affine constant on the host by squaring
// A8 (ops/crc32c_cuda.py fold_operators), from the same _advance algebra as
// crc32c_jax.py's _matrices.
//
// Stage 1 (crc32c_segments): one thread a segment, a block 256 segments of
// one row (fewer when the padded row has fewer). A thread reads its 256
// bytes as 16 16-byte loads and runs slicing-by-8 over 8 tables of 256
// entries held in shared memory (8 KB); a segment that is short (segment 0)
// or whose address is off a 16-byte boundary goes byte by byte through the
// first table. The block then folds its 256 states in shared memory over 8
// levels and writes one partial state.
// Stage 2 (crc32c_fold): one block a row folds the row's partials, 1024 at
// a time over up to 10 more levels, carrying the chunks left to right
// (acc = A8^(chunk bytes)(acc) ^ chunk), and writes the CRC, XORed with the
// affine constant and 0xFFFFFFFF, as an int64.
//
// What bounds it: HBM bytes. At (64, 1 MiB), the shape bench.py times,
// 64 MiB in and a word per row out take 20.0 us at 3.35 TB/s; the partial
// states (64 x 16 words) and the operators are noise. Per 8 input bytes a
// thread does 8 shared-memory lookups and about 20 INT32 operations; the
// lookups' indices are data, so lanes meet in banks at random (a few-way
// conflict on average). That work is about as large as the byte bound, so
// the kernel can reach only a part of it; the int8 wgmma form of the two
// products (ROADMAP Queue 2) is the lead for a later change. Each thread's
// 16-byte loads stride 256 bytes across the warp, so a warp's load touches
// 32 sectors and the next load of each thread finds the rest of its sector
// in L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 256;           // bytes per segment: one thread
constexpr int kBlockSegs = 256;     // most segments (threads) per stage-1 block
constexpr int kBlockLevels = 8;     // log2(kBlockSegs)
constexpr int kFoldThreads = 1024;  // most partials a stage-2 block folds at once
constexpr int kFoldLevels = 10;     // log2(kFoldThreads)
constexpr int kMaxLevels = 40;

// apply a GF(2) operator, given as its 32 columns, to a 32-bit state
__device__ __forceinline__ uint32_t apply_op(const uint32_t* op, uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    r ^= op[b] & (0u - ((v >> b) & 1u));
  }
  return r;
}

// slicing-by-8: advance the register over the 8 bytes lo (first 4, little
// endian) and hi (next 4); t[k][i] is t[0][i] advanced by k zero bytes
__device__ __forceinline__ uint32_t step8(uint32_t (*t)[256],
                                          uint32_t crc, uint32_t lo,
                                          uint32_t hi) {
  crc ^= lo;
  return t[7][crc & 0xff] ^ t[6][(crc >> 8) & 0xff] ^
         t[5][(crc >> 16) & 0xff] ^ t[4][crc >> 24] ^ t[3][hi & 0xff] ^
         t[2][(hi >> 8) & 0xff] ^ t[1][(hi >> 16) & 0xff] ^ t[0][hi >> 24];
}

__global__ void __launch_bounds__(kBlockSegs)
crc32c_segments(const uint8_t* __restrict__ data, long long stride,
                long long n, long long segs, long long padded,
                int block_levels, const uint32_t* __restrict__ tables,
                const uint32_t* __restrict__ ops,
                uint32_t* __restrict__ partial) {
  __shared__ uint32_t t[8][256];
  __shared__ uint32_t op[kBlockLevels][32];
  __shared__ uint32_t st[kBlockSegs];
  const int tid = threadIdx.x;
  const int block_segs = blockDim.x;
  for (int i = tid; i < 8 * 256; i += block_segs) (&t[0][0])[i] = tables[i];
  for (int i = tid; i < block_levels * 32; i += block_segs) {
    (&op[0][0])[i] = ops[i];
  }
  __syncthreads();

  const long long row = blockIdx.y;
  const long long p = static_cast<long long>(blockIdx.x) * block_segs + tid;
  const long long s = p - (padded - segs);  // < 0: a zero pad in front
  uint32_t crc = 0;
  if (s >= 0) {
    const long long end = n - (segs - 1 - s) * kSeg;
    const long long begin = end > kSeg ? end - kSeg : 0;
    const uint8_t* src = data + row * stride + begin;
    const long long len = end - begin;
    if (len == kSeg && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll 4
      for (int i = 0; i < kSeg / 16; ++i) {
        const uint4 w = __ldg(v + i);
        crc = step8(t, crc, w.x, w.y);
        crc = step8(t, crc, w.z, w.w);
      }
    } else {
      for (long long i = 0; i < len; ++i) {
        crc = (crc >> 8) ^ t[0][(crc ^ src[i]) & 0xff];
      }
    }
  }
  st[tid] = crc;
  __syncthreads();
  // pairwise fold: at level j the left node is advanced over the right
  // node's 256 * 2^j bytes
  for (int j = 0; j < block_levels; ++j) {
    const int half = 1 << j;
    if ((tid & (2 * half - 1)) == 0) {
      st[tid] = apply_op(op[j], st[tid]) ^ st[tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) partial[row * gridDim.x + blockIdx.x] = st[0];
}

__global__ void __launch_bounds__(kFoldThreads)
crc32c_fold(const uint32_t* __restrict__ partial, long long parts,
            int first_level, int chunk_levels,
            const uint32_t* __restrict__ ops, uint32_t aff,
            long long* __restrict__ out) {
  __shared__ uint32_t op[kFoldLevels + 1][32];
  __shared__ uint32_t st[kFoldThreads];
  const int tid = threadIdx.x;
  const int chunk = blockDim.x;
  // levels first_level .. first_level + chunk_levels; the last one moves
  // the carried state over a whole chunk
  for (int i = tid; i < (chunk_levels + 1) * 32; i += chunk) {
    (&op[0][0])[i] = ops[first_level * 32 + i];
  }
  __syncthreads();
  const uint32_t* src = partial + static_cast<long long>(blockIdx.x) * parts;
  uint32_t acc = 0;
  for (long long c = 0; c < parts; c += chunk) {
    st[tid] = src[c + tid];
    __syncthreads();
    for (int j = 0; j < chunk_levels; ++j) {
      const int half = 1 << j;
      if ((tid & (2 * half - 1)) == 0) {
        st[tid] = apply_op(op[j], st[tid]) ^ st[tid + half];
      }
      __syncthreads();
    }
    if (tid == 0) acc = apply_op(op[chunk_levels], acc) ^ st[0];
    __syncthreads();
  }
  if (tid == 0) {
    out[blockIdx.x] = static_cast<long long>(acc ^ aff ^ 0xFFFFFFFFu);
  }
}

}  // namespace

// CRC32C of `rows` rows of n bytes, row r at data + r * stride, into
// out[r] (int64). tables: the 8 x 256 slicing tables; ops: levels + 1
// operators of 32 columns, ops[j] = A8^(256 * 2^j); levels =
// ceil(log2(ceil(n / 256))); aff = A8^n(0xFFFFFFFF); partial: rows x
// (2^levels / min(2^levels, 256)) words of scratch. Launches two kernels on
// `stream` and returns the first CUDA error, or 0.
extern "C" int swtpu_crc32c_batch(const void* data, long long stride,
                                  long long rows, long long n,
                                  const void* tables, const void* ops,
                                  int levels, unsigned int aff,
                                  void* partial, void* out, void* stream) {
  if (rows < 0 || n < 1 || levels < 0 || levels > kMaxLevels ||
      rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const long long segs = (n + kSeg - 1) / kSeg;
  const long long padded = 1LL << levels;
  if (padded < segs || (levels > 0 && (padded >> 1) >= segs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int block_levels = levels < kBlockLevels ? levels : kBlockLevels;
  const long long parts = padded >> block_levels;
  const int chunk_levels =
      levels - block_levels < kFoldLevels ? levels - block_levels
                                          : kFoldLevels;
  if (parts > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1(static_cast<unsigned>(parts), static_cast<unsigned>(rows));
  crc32c_segments<<<grid1, 1 << block_levels, 0, s>>>(
      static_cast<const uint8_t*>(data), stride, n, segs, padded,
      block_levels, static_cast<const uint32_t*>(tables),
      static_cast<const uint32_t*>(ops), static_cast<uint32_t*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  crc32c_fold<<<static_cast<unsigned>(rows), 1 << chunk_levels, 0, s>>>(
      static_cast<const uint32_t*>(partial), parts, block_levels,
      chunk_levels, static_cast<const uint32_t*>(ops), aff,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
