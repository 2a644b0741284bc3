// GF(256) shard transform for Hopper (sm_90a): out = C (x) x over GF(2^8).
//
// Replaces seaweedfs_tpu/ops/gf256_pallas.py::_make_kernel (the Pallas TPU
// kernel K1, body _accumulate_bitplanes); the stacked entry of the wrapper
// launches it for ::_make_stacked_kernel (K2) too. It computes the same
// function: for every byte column, out[b, r] = XOR_i gf_mul(C[r, i], x[b, i]),
// where C is a (rows, k) coefficient matrix handed over as its (rows, k, 8)
// bitplane constants K[r, i, j] = gf_mul(C[r, i], 1 << j)
// (gf.bitplane_constants).
//
// Math: gf_mul(c, v) is linear in v over GF(2), so it splits over the two
// nibbles of v: gf_mul(c, v) = lo[v & 15] ^ hi[v >> 4], where
//     lo[u] = XOR_{j < 4, bit j of u} K[r, i, j]
//     hi[u] = XOR_{j < 4, bit j of u} K[r, i, 4 + j].
// Each block builds, in its prologue, two 16-entry uint32 tables for every
// input i and every group g of 4 output rows: byte q of T_lo[g][i][u] is
// lo[u] of row 4g + q, T_hi likewise with hi, and rows past the last are
// zero bytes. Per input byte the body reads the two entries and XORs both
// into its byte column's packed accumulator (one LOP3), which carries the
// group's 4 rows in one word. The epilogue transposes the 16 column words
// of a chunk, 4 x 4 bytes at a time with __byte_perm, into 4 rows of 16
// bytes and writes each row with one 16-byte store.
//
// What bounds it: HBM bytes. The pipeline's block, (8, 10, 1 MiB) in and
// (8, 4, 1 MiB) out, is 117 MB, 35 us at 3.35 TB/s. Per 4 input bytes and
// per group of 4 rows the body issues 8 shared loads (LDS) and
// 12 + 4 INT32-pipe operations: two shift-and-mask pairs give the four low-
// and the four high-nibble offsets of the word at once, one __byte_perm
// picks each out, and one LOP3 per byte accumulates. That is 16.8 INT32
// operations per input word at 4 rows with the epilogue, against 48 for the
// bitplane form this kernel replaced, and no multiply; with 64 INT32 lanes
// and 32 shared-memory banks per SM both pipes need about 60% of the byte
// bound's time (chip_smoke.py prints the counts beside the measured time).
// Each further group of 4 rows adds 8 LDS and 4 LOP3 per input word; the
// offsets are shared.
//
// Shared memory: the tables take G x 16 inputs x 2 x 64 B, G = ceil(rows / 4)
// groups: 2 KB at rows <= 4, 8 KB at 16 rows, static. Each 16-word table
// starts on a 16-word boundary, so it spans 16 distinct banks; the 32 lanes
// of a warp always read one table at a time, so distinct entries lie in
// distinct banks and equal entries broadcast: no bank conflict.
//
// Why not tensor cores: as a GF(2) bit-matrix product on the int8 tensor
// cores (1,979 TOP/s) the transform needs 62% of the byte bound before the
// work of unpacking every byte into 8 int8 values and packing the parity
// bits back, which costs about what the bitplane form's extraction did. They
// cannot reach the byte bound here; they belong to the port of
// ops/gf256_mxu.py.
//
// Layout and grid: the kernel takes (B, k, L) bytes with the batch and shard
// axes strided, so a (B, k+m, L) block is read in place. Each thread owns 16
// contiguous bytes (a chunk) of one window and issues the 16-byte loads of
// all k inputs before the first lookup, so a thread has k x 16 B in flight;
// a block's first loads are issued before it builds its tables, so the
// prologue hides behind them. The grid is at most one wave of blocks (as
// many as fit on every SM), sized so that every thread strides over the same
// number of the batch's (window, chunk) pairs. A chunk whose rows start off
// a 16-byte boundary, or the ragged tail of a window, goes through a byte
// path on the same tables. One build serves every coefficient matrix: the
// constants are a runtime tensor, and only the number of row groups is a
// template parameter, so the accumulators live in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;
constexpr int kMaxK = 16;
constexpr int kGroupRows = 4;
constexpr int kThreads = 128;

// [group][input][0 = low nibble, 1 = high nibble][nibble value]
template <int G>
using Tables = uint32_t[G][kMaxK][2][16];

// Fill the tables. Every 16-entry table is the XOR span of 4 basis words
// (bit j of the nibble selects basis j), so the block first reads, in one
// round trip to global memory, the basis bytes K[4g + q, i, 4h + j] packed
// by q, then spans each table in shared memory. Ends with a barrier.
template <int G>
__device__ __forceinline__ void build_tables(const uint8_t* __restrict__ consts,
                                             int rows, int k, Tables<G>& tab,
                                             uint32_t (&basis)[G][kMaxK][2][4]) {
  for (int e = threadIdx.x; e < G * k * 8; e += blockDim.x) {
    const int j = e & 3;
    const int half = (e >> 2) & 1;
    const int gi = e >> 3;
    const int g = gi / k;
    const int i = gi - g * k;
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < kGroupRows; ++q) {
      const int r = g * kGroupRows + q;
      if (r < rows) {
        word |= static_cast<uint32_t>(__ldg(consts + (r * k + i) * 8 +
                                            4 * half + j))
                << (8 * q);
      }
    }
    basis[g][i][half][j] = word;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * k * 32; e += blockDim.x) {
    const int u = e & 15;
    const int half = (e >> 4) & 1;
    const int gi = e >> 5;
    const int g = gi / k;
    const int i = gi - g * k;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((u >> j) & 1) word ^= basis[g][i][half][j];
    }
    tab[g][i][half][u] = word;
  }
  __syncthreads();
}

// The entry of a 16-word table at a byte offset that is 4 x the nibble.
__device__ __forceinline__ uint32_t entry(const uint32_t* table,
                                          uint32_t byte_off) {
  return *reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const uint8_t*>(table) + byte_off);
}

// XOR gf_mul(C[r, i], byte) of the 4 bytes of input word w into the packed
// accumulators of their columns, acc[g][c0 .. c0 + 3].
template <int G>
__device__ __forceinline__ void accumulate_word(const Tables<G>& tab, int i,
                                                uint32_t w, int c0,
                                                uint32_t (&acc)[G][16]) {
  // byte b of lo (hi) is 4 x the low (high) nibble of byte b of w: the byte
  // offset of its table entry
  const uint32_t lo = (w << 2) & 0x3C3C3C3Cu;
  const uint32_t hi = (w >> 2) & 0x3C3C3C3Cu;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t ol = __byte_perm(lo, 0, 0x4440 + b);
    const uint32_t oh = __byte_perm(hi, 0, 0x4440 + b);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g][c0 + b] ^= entry(tab[g][i][0], ol) ^ entry(tab[g][i][1], oh);
    }
  }
}

// 4 x 4 byte transpose: a[c] holds rows 0..3 of column c in its bytes;
// row q of the result holds column c of row q in byte c.
__device__ __forceinline__ void transpose4(const uint32_t* a, uint32_t* row) {
  const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140);  // a0.0 a1.0 a0.1 a1.1
  const uint32_t t1 = __byte_perm(a[0], a[1], 0x7362);  // a0.2 a1.2 a0.3 a1.3
  const uint32_t u0 = __byte_perm(a[2], a[3], 0x5140);
  const uint32_t u1 = __byte_perm(a[2], a[3], 0x7362);
  row[0] = __byte_perm(t0, u0, 0x5410);
  row[1] = __byte_perm(t0, u0, 0x7632);
  row[2] = __byte_perm(t1, u1, 0x5410);
  row[3] = __byte_perm(t1, u1, 0x7632);
}

// The k 16-byte loads of a chunk whose rows start on 16-byte boundaries,
// all issued before any of them is used.
__device__ __forceinline__ void load_chunk(int k, const uint8_t* xp,
                                           long long x_sk, uint4 (&v)[kMaxK]) {
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    if (i < k) v[i] = __ldg(reinterpret_cast<const uint4*>(xp + i * x_sk));
  }
}

// The lookups of a loaded chunk, the transpose and one 16-byte store per
// output row.
template <int G>
__device__ __forceinline__ void chunk_vector(const Tables<G>& tab, int rows,
                                             int k, const uint4 (&v)[kMaxK],
                                             uint8_t* op, long long o_sr) {
  uint32_t acc[G][16];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[g][c] = 0;
  }
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    if (i < k) {
      accumulate_word<G>(tab, i, v[i].x, 0, acc);
      accumulate_word<G>(tab, i, v[i].y, 4, acc);
      accumulate_word<G>(tab, i, v[i].z, 8, acc);
      accumulate_word<G>(tab, i, v[i].w, 12, acc);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    uint32_t out[4][4];  // [row q of the group][word]
#pragma unroll
    for (int word = 0; word < 4; ++word) {
      uint32_t row[4];
      transpose4(&acc[g][4 * word], row);
#pragma unroll
      for (int q = 0; q < 4; ++q) out[q][word] = row[q];
    }
#pragma unroll
    for (int q = 0; q < kGroupRows; ++q) {
      const int r = g * kGroupRows + q;
      if (r < rows) {
        *reinterpret_cast<uint4*>(op + r * o_sr) =
            make_uint4(out[q][0], out[q][1], out[q][2], out[q][3]);
      }
    }
  }
}

// The first n (<= 16) bytes of a chunk, one byte column at a time: for the
// ragged tail of a window and for rows off a 16-byte boundary.
template <int G>
__device__ __forceinline__ void chunk_bytes(const Tables<G>& tab, int rows,
                                            int k, const uint8_t* xp,
                                            long long x_sk, uint8_t* op,
                                            long long o_sr, int n) {
  for (int p = 0; p < n; ++p) {
    uint32_t acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0;
    for (int i = 0; i < k; ++i) {
      const uint32_t v = xp[i * x_sk + p];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc[g] ^= tab[g][i][0][v & 15] ^ tab[g][i][1][v >> 4];
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int q = 0; q < kGroupRows; ++q) {
        const int r = g * kGroupRows + q;
        if (r < rows) {
          op[r * o_sr + p] = static_cast<uint8_t>(acc[g] >> (8 * q));
        }
      }
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
gf256_transform_kernel(const uint8_t* __restrict__ consts, int rows, int k,
                       const uint8_t* __restrict__ x, long long x_sb,
                       long long x_sk, uint8_t* __restrict__ out,
                       long long o_sb, long long o_sr, long long batch,
                       long long length) {
  __shared__ __align__(64) Tables<G> tab;
  __shared__ uint32_t basis[G][kMaxK][2][4];

  // the (window, chunk) pairs of the batch, strided over the whole grid
  const long long chunks = (length + 15) >> 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  long long b = first / chunks;
  long long c = first - b * chunks;
  const long long db = stride / chunks;
  const long long dc = stride - db * chunks;
  // a row stride only matters for alignment when there is a second row
  const unsigned long long steps =
      static_cast<unsigned long long>(k > 1 ? x_sk : 0) |
      static_cast<unsigned long long>(rows > 1 ? o_sr : 0);

  const uint8_t* xp = nullptr;
  uint8_t* op = nullptr;
  long long n = 0;
  bool vector = false;
  uint4 v[kMaxK];
  // where chunk (b, c) lies, and its loads when it takes the vector path
  auto place = [&]() {
    const long long off = c << 4;
    n = length - off;
    xp = x + b * x_sb + off;
    op = out + b * o_sb + off;
    vector = n >= 16 && ((reinterpret_cast<uintptr_t>(xp) |
                          reinterpret_cast<uintptr_t>(op) | steps) & 15) == 0;
    if (vector) load_chunk(k, xp, x_sk, v);
  };

  // the first chunk's loads are in flight while the block builds its tables
  if (b < batch) place();
  build_tables<G>(consts, rows, k, tab, basis);

  while (b < batch) {
    if (vector) {
      chunk_vector<G>(tab, rows, k, v, op, o_sr);
    } else {
      chunk_bytes<G>(tab, rows, k, xp, x_sk, op, o_sr,
                     n < 16 ? static_cast<int>(n) : 16);
    }
    b += db;
    c += dc;
    if (c >= chunks) {
      c -= chunks;
      ++b;
    }
    if (b < batch) place();
  }
}

template <int G>
int blocks_per_sm() {
  static int cached = 0;
  if (cached == 0) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, gf256_transform_kernel<G>, kThreads, 0) != cudaSuccess) {
      return 0;
    }
    cached = n;
  }
  return cached;
}

int blocks_per_sm_for(int groups) {
  switch (groups) {
    case 1: return blocks_per_sm<1>();
    case 2: return blocks_per_sm<2>();
    case 3: return blocks_per_sm<3>();
    case 4: return blocks_per_sm<4>();
  }
  return 0;
}

// The current device's SM count, asked of the runtime once a device: a
// chain launches K1 once a piece, and the two queries would otherwise
// double the runtime calls a launch makes.
cudaError_t sm_count(int* sms) {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kDevices) {
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                  device);
  }
  if (cached[device] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    cached[device] = n;
  }
  *sms = cached[device];
  return cudaSuccess;
}

// K1 over a (batch, k, length) block on `s`, without synchronising:
// cudaGetLastError() after the launch, or the error of the device query.
cudaError_t launch_transform(const uint8_t* c, int rows, int k,
                             const uint8_t* xi, long long x_sb,
                             long long x_sk, uint8_t* o, long long o_sb,
                             long long o_sr, long long batch,
                             long long length, cudaStream_t s) {
  if (batch == 0 || length == 0) return cudaSuccess;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int groups = (rows + kGroupRows - 1) / kGroupRows;
  const int per_sm = blocks_per_sm_for(groups);
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;

  // at most one wave of blocks, sized so that every thread takes the same
  // number of chunks (the last ones one fewer)
  const long long chunks = (length + 15) / 16;
  const long long total = batch * chunks;
  const long long wave = static_cast<long long>(sms) * per_sm * kThreads;
  const long long per_thread = (total + wave - 1) / wave;
  const long long blocks =
      (total + per_thread * kThreads - 1) / (per_thread * kThreads);
  const dim3 grid(static_cast<unsigned>(blocks));

  switch (groups) {
    case 1:
      gf256_transform_kernel<1><<<grid, kThreads, 0, s>>>(
          c, rows, k, xi, x_sb, x_sk, o, o_sb, o_sr, batch, length);
      break;
    case 2:
      gf256_transform_kernel<2><<<grid, kThreads, 0, s>>>(
          c, rows, k, xi, x_sb, x_sk, o, o_sb, o_sr, batch, length);
      break;
    case 3:
      gf256_transform_kernel<3><<<grid, kThreads, 0, s>>>(
          c, rows, k, xi, x_sb, x_sk, o, o_sb, o_sr, batch, length);
      break;
    case 4:
      gf256_transform_kernel<4><<<grid, kThreads, 0, s>>>(
          c, rows, k, xi, x_sb, x_sk, o, o_sb, o_sr, batch, length);
      break;
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. Every pointer is a
// device pointer; strides are in bytes (elements of uint8). Launches on
// `stream` and does not synchronise. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for shapes the kernel
// does not take.
extern "C" int swtpu_gf256_transform(const void* consts, int rows, int k,
                                     const void* x, long long x_sb,
                                     long long x_sk, void* out,
                                     long long o_sb, long long o_sr,
                                     long long batch, long long length,
                                     void* stream) {
  if (rows < 1 || rows > kMaxRows || k < 1 || k > kMaxK || batch < 0 ||
      length < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_transform(
      static_cast<const uint8_t*>(consts), rows, k,
      static_cast<const uint8_t*>(x), x_sb, x_sk, static_cast<uint8_t*>(out),
      o_sb, o_sr, batch, length, static_cast<cudaStream_t>(stream)));
}

// The card recover of one window as one chain of pieces on two streams.
//
// A recover copies its k survivor rows of L bytes in, runs K1 and copies
// its `rows` recovered rows out. One after another on one stream, the copy
// out and K1 wait for the whole copy in, though the card copies in and out
// on separate engines. Cut along L into pieces [bounds[i], bounds[i + 1]),
// piece i's K1 and copy out need only piece i's columns. So for each piece
// this enqueues, on stream A, the copy in of the piece's k x w survivor
// bytes and an event after it, and on stream B a wait for that event, K1
// over the piece and the copy out of its columns of the `rows` rows. Then
// it records `done` on B. Piece i's K1 and copy out run while A copies
// piece i + 1 in; the copies out total rows x L bytes.
//
// The survivors are staged piece-major, so each piece's copy in is one
// contiguous cudaMemcpyAsync: piece i's (k, w) rows lie at k x bounds[i]
// of host_in and dev_in, each row w bytes. K1 reads them with row stride w
// and writes the piece's columns of dev_out, a (rows, L) block; the copy
// out is one 2-D copy of those columns (pitch L) into host_out, (rows, L)
// too. Bounds that are multiples of 16 keep every piece on K1's 16-byte
// vector path (a ragged last piece takes its byte path).
//
// One call enqueues the whole chain, so the host's cost of a recover does
// not grow with the pieces: ctypes releases the interpreter's lock for the
// call, and the card never waits for the host between two pieces.
//
// host_in and host_out are pinned host buffers, dev_in and dev_out device
// buffers; `events` holds `pieces` events made by swtpu_chain_events. The
// caller keeps every buffer alive and the events unused until `done`
// completes. Returns the first CUDA error (0 on success), or
// cudaErrorInvalidValue for a shape or plan the chain does not take.
extern "C" int swtpu_gf256_chain(const void* consts, int rows, int k,
                                 const void* host_in, void* dev_in,
                                 void* dev_out, void* host_out,
                                 long long length, const long long* bounds,
                                 int pieces, void* stream_a, void* stream_b,
                                 void* const* events, void* done) {
  if (rows < 1 || rows > kMaxRows || k < 1 || k > kMaxK || length < 1 ||
      pieces < 1 || bounds[0] != 0 || bounds[pieces] != length) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < pieces; ++i) {
    if (bounds[i + 1] <= bounds[i]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const uint8_t* c = static_cast<const uint8_t*>(consts);
  const uint8_t* hin = static_cast<const uint8_t*>(host_in);
  uint8_t* din = static_cast<uint8_t*>(dev_in);
  uint8_t* dout = static_cast<uint8_t*>(dev_out);
  uint8_t* hout = static_cast<uint8_t*>(host_out);
  cudaStream_t sa = static_cast<cudaStream_t>(stream_a);
  cudaStream_t sb = static_cast<cudaStream_t>(stream_b);
  const size_t pitch = static_cast<size_t>(length);
  for (int i = 0; i < pieces; ++i) {
    const long long a = bounds[i];
    const long long w = bounds[i + 1] - a;
    const long long at = k * a;  // the piece's first byte, piece-major
    cudaEvent_t landed = static_cast<cudaEvent_t>(events[i]);
    cudaError_t err =
        cudaMemcpyAsync(din + at, hin + at, static_cast<size_t>(k * w),
                        cudaMemcpyHostToDevice, sa);
    if (err == cudaSuccess) err = cudaEventRecord(landed, sa);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(sb, landed, 0);
    if (err == cudaSuccess) {
      err = launch_transform(c, rows, k, din + at, k * w, w, dout + a,
                             rows * length, length, 1, w, sb);
    }
    if (err == cudaSuccess) {
      err = cudaMemcpy2DAsync(hout + a, pitch, dout + a, pitch,
                              static_cast<size_t>(w), rows,
                              cudaMemcpyDeviceToHost, sb);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(
      cudaEventRecord(static_cast<cudaEvent_t>(done), sb));
}

// Create n events for chains (no timing, so a record costs no timestamp)
// into out[0 .. n). Returns the first CUDA error, 0 on success.
extern "C" int swtpu_chain_events(int n, void** out) {
  for (int i = 0; i < n; ++i) {
    cudaEvent_t e = nullptr;
    const cudaError_t err =
        cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[i] = e;
  }
  return 0;
}

// Block until a chain's `done` event has completed. Returns its CUDA error
// (0 on success).
extern "C" int swtpu_chain_wait(void* done) {
  return static_cast<int>(
      cudaEventSynchronize(static_cast<cudaEvent_t>(done)));
}
