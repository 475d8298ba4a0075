// Substring search over a string column's char matrix for Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_tpu/exprs/pallas_strings.py:_run_contains
// (kernel body _contains_kernel at :48, pallas_call at :73), with the contract
// of its plain form Contains._match (spark_rapids_tpu/exprs/strings.py:370):
// out[r] is 1 iff some window j with j + k <= len[r] has
// chars[r, j:j+k] == pat, for r in [0, rows).  chars is (rows, W) uint8 with
// W a power of two >= 8, as every width of the port is; len is int32,
// clamped here to [0, W]; 1 <= k <= W (the caller answers k == 0 and k > W
// without a launch).  Bytes at or after len[r] never take part in a match,
// whatever they hold, so a gathered or concatenated char matrix needs no
// zeroing.
//
// What bounds it.  A match needs only the first len[r] bytes of each row
// that can hold the needle (len[r] >= k), each length once and one output
// byte a row; a bit-parallel scan is a few operations a byte, below the
// card's rate.  So it is bound by bytes.  At the main path's shape (a
// 2^20-row batch of l_comment, W = 64, k = 16, lengths 10 to 43) that is
// 30.72 MB, 9.2 us at 3.35 TB/s; the full planes are 72.35 MB.
// chip_smoke.py computes the bound from the data it runs and the rate of
// the card it runs on.
//
// The first design took 99.8 us on an NVIDIA H100 80GB HBM3 at a 700 W
// power limit: a warp staged eight whole 64-byte rows (the full planes)
// and walked them one after another, each lane testing a window with a
// byte-at-a-time early-exit compare and the row ending in a shuffle and a
// vote.
//
// This design:
//   * Thread t takes row t of each tile of R rows (256 at W = 64; fewer
//     for wide rows, so a block stays near 48 KB), tile after tile in a
//     grid of one wave.  It loads its rows' lengths three tiles ahead and
//     copies, with cp.async, only the 16-byte chunks below its row's
//     length into its own stage row, none of a row shorter than the
//     needle: no sector past a length is asked for.  Two stages: the next
//     tile's copies are in flight while this one is scanned.  A thread
//     reads only what it copied, so the loop has no barrier.  Stage rows
//     are W + 16 bytes apart, an odd number of 16-byte units, so the
//     16-byte reads of threads t and t + 1 meet no bank conflict.
//   * Needles of up to 64 bytes: the thread scans its row with Shift-And.
//     The state is one 32-bit (k <= 32) or 64-bit register; the needle's
//     256-entry byte-mask table is built once a block in shared memory
//     from the needle, which comes by value in the launch's parameters.
//     16 bytes a shared-memory load, the last partial chunk masked, and a
//     stop at the first hit.  No vote, no shuffle, no row after row.
//   * Longer needles (right, not tuned; no routed query has one): a 4-byte
//     prefilter on each window, then a full compare.  Needles of up to 1 KB
//     come by value too; longer ones from a card buffer.
//   * The answers of a tile are consecutive bytes, so the stores coalesce.
//
// On the card (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): 37.5 to
// 37.8 us with the batch partly in L2, 47.6 to 47.8 us cold, 35.1 to
// 35.5 us of device time, against 98.5 to 100.6 us for the first design
// in the same call and the 9.2 us bound of the bytes a match needs.  The
// scan is about six instructions and one table load a byte, a warp runs
// to its longest row, and the copies of 16 to 48 bytes a row overlap it
// only in part.  Neither coalesced copies (other threads' rows, with
// barriers) nor one stage, nor smaller tiles did better.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define CT_SMEM_MAX 232448    // bytes of shared memory a Hopper block may use
#define CT_SHIFT_AND_MAX 64   // longest needle of the Shift-And paths
#define CT_NEEDLE_BYTES 1024  // longest needle that goes by value
#define CT_MAX_THREADS 256
#define CT_MAX_DEVICES 64

enum { PATH_SHIFT_AND32 = 0, PATH_SHIFT_AND64 = 1, PATH_LONG = 2 };

struct Needle {
  unsigned char b[CT_NEEDLE_BYTES];
};

// A row's length clamped to [0, W]; 0 past the last row and for a row too
// short to hold the needle: such a row needs no byte.
__device__ __forceinline__ int row_len(const int32_t* __restrict__ lens,
                                       long long row, long long rows, int W,
                                       int k) {
  if (row >= rows) return 0;
  int l = lens[row];
  l = l < 0 ? 0 : (l > W ? W : l);
  return l < k ? 0 : l;
}

// cp.async the 16-byte chunks of a row below its length (the one 8-byte
// chunk when W == 8, into a 16-byte stage row) into the thread's own
// stage row.
__device__ __forceinline__ void copy_row(const unsigned char* __restrict__ src,
                                         unsigned char* dst, int len, int W) {
  if (W >= 16) {
    for (int c = 0; c < len; c += 16)
      __pipeline_memcpy_async(dst + c, src + c, 16);
  } else if (len > 0) {
    __pipeline_memcpy_async(dst, src, 8);
  }
}

// Thread t takes row t of each tile of R rows, tile after tile
// (grid-stride): it copies its own row into its stage row and scans only
// that, so the loop needs no barrier.  A copy needs its row's length, so
// lengths are loaded three tiles ahead; with two stages the next tile's
// copies are in flight while this one is scanned, with one (the widest
// rows) they follow the scan.
template <typename Scan>
__device__ __forceinline__ void scan_tiles(
    const unsigned char* __restrict__ chars, const int32_t* __restrict__ lens,
    long long rows, int W, int R, int stride, int stages, int k,
    unsigned char* stage, unsigned char* __restrict__ out, const Scan& scan) {
  const int t = threadIdx.x;
  const bool active = t < R;
  const long long tiles = (rows + R - 1) / R;
  const long long step = gridDim.x;
  auto length = [&](long long tile) {
    return active && tile < tiles ? row_len(lens, tile * R + t, rows, W, k)
                                  : 0;
  };
  auto copy = [&](long long tile, int len, int buf) {
    if (active && tile < tiles)
      copy_row(chars + (tile * R + t) * W, stage + (buf * R + t) * stride,
               len, W);
    __pipeline_commit();
  };
  long long tile = blockIdx.x;
  int len0 = length(tile), len1 = length(tile + step);
  int len2 = length(tile + 2 * step);
  copy(tile, len0, 0);
  for (int i = 0; tile < tiles; ++i, tile += step) {
    const int len3 = length(tile + 3 * step);
    const int cur = stages == 2 ? (i & 1) : 0;
    if (stages == 2) {
      copy(tile + step, len1, cur ^ 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    const long long row = tile * R + t;
    if (active && row < rows)
      out[row] = scan(stage + (cur * R + t) * stride, len0) ? 1 : 0;
    if (stages == 1) copy(tile + step, len1, 0);
    len0 = len1;
    len1 = len2;
    len2 = len3;
  }
}

// Shift-And: bit i of the state is set when the needle's first i + 1
// bytes end at the current byte; table[c] has bit i set when pat[i] == c.
template <typename M> struct ShiftAnd {
  const M* table;
  M last;  // bit k - 1: a whole match
  // the word's bytes at or past `left` leave the state as it is
  __device__ __forceinline__ void step(uint32_t w, int left, M& d,
                                       M& seen) const {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const M next = ((d << 1) | 1) & table[(w >> (8 * b)) & 0xff];
      d = b < left ? next : d;
      seen |= d;
    }
  }
  // 16 bytes a shared-memory load; the last, partial chunk is read whole
  // (its bytes past the length were copied with it) and masked
  __device__ __forceinline__ bool operator()(const unsigned char* row,
                                             int len) const {
    M d = 0, seen = 0;  // seen: every state so far, for the match bit
    for (int i = 0; i < len; i += 16) {
      const uint4 q = *reinterpret_cast<const uint4*>(row + i);
      const int left = len - i;
      if (left >= 16) {
        step(q.x, 4, d, seen);
        step(q.y, 4, d, seen);
        step(q.z, 4, d, seen);
        step(q.w, 4, d, seen);
      } else {
        step(q.x, left, d, seen);
        step(q.y, left - 4, d, seen);
        step(q.z, left - 8, d, seen);
        step(q.w, left - 12, d, seen);
      }
      if (seen & last) return true;
    }
    return false;
  }
};

// Needles past 64 bytes: the window's first 4 bytes against the needle's,
// then the rest byte by byte.  j + k <= len and k > 64, so word
// (j >> 2) + 1 lies below the length.
struct Prefilter {
  const unsigned char* pat;  // the launch's parameters or a card buffer
  int k;
  uint32_t first;
  __device__ __forceinline__ bool operator()(const unsigned char* row,
                                             int len) const {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
    for (int j = 0; j + k <= len; ++j) {
      const uint32_t w =
          __funnelshift_r(words[j >> 2], words[(j >> 2) + 1], 8 * (j & 3));
      if (w == first) {
        int t = 4;
        while (t < k && row[j + t] == pat[t]) ++t;
        if (t == k) return true;
      }
    }
    return false;
  }
};

// M: unsigned int for k <= 32, unsigned long long for k <= 64
template <typename M>
__global__ void __launch_bounds__(CT_MAX_THREADS)
    contains_shift_and(const unsigned char* __restrict__ chars,
                       const int32_t* __restrict__ lens, long long rows,
                       int W, int R, int stride, int stages,
                       const __grid_constant__ Needle nd, int k,
                       unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  M* table = reinterpret_cast<M*>(smem);
  for (int c = threadIdx.x; c < 256; c += blockDim.x) table[c] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    atomicOr(&table[nd.b[i]], (M)1 << i);
  __syncthreads();
  const ShiftAnd<M> scan{table, (M)1 << (k - 1)};
  scan_tiles(chars, lens, rows, W, R, stride, stages, k,
             smem + 256 * sizeof(M), out, scan);
}

__global__ void __launch_bounds__(CT_MAX_THREADS)
    contains_long(const unsigned char* __restrict__ chars,
                  const int32_t* __restrict__ lens, long long rows, int W,
                  int R, int stride, int stages,
                  const __grid_constant__ Needle nd,
                  const unsigned char* __restrict__ pat_dev, int k,
                  unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned char* pat = k <= CT_NEEDLE_BYTES ? nd.b : pat_dev;
  const Prefilter scan{pat, k,
                       (uint32_t)pat[0] | ((uint32_t)pat[1] << 8) |
                           ((uint32_t)pat[2] << 16) |
                           ((uint32_t)pat[3] << 24)};
  scan_tiles(chars, lens, rows, W, R, stride, stages, k, smem, out, scan);
}

// ---- C interface -----------------------------------------------------------

// The kernels' largest dynamic shared memory, set once a device.
static cudaError_t setup_once() {
  static bool ready[CT_MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < CT_MAX_DEVICES && ready[dev]) return cudaSuccess;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((e = cudaFuncSetAttribute(contains_shift_and<unsigned int>, a,
                                CT_SMEM_MAX)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(contains_shift_and<unsigned long long>, a,
                                CT_SMEM_MAX)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(contains_long, a, CT_SMEM_MAX)) !=
          cudaSuccess)
    return e;
  if (dev < CT_MAX_DEVICES) ready[dev] = true;
  return cudaSuccess;
}

// out[r] (one byte, 0 or 1) for r in [0, rows): whether the k-byte needle
// occurs in row r of the (rows, W) char matrix before len[r].  `grid`
// blocks of `threads` threads take tiles of R rows, `stages` (1 or 2)
// stages of rows `stride` bytes apart; `smem` bytes of dynamic shared
// memory a block.  path 0 and 1 (Shift-And, k <= 32 and k <= 64), path 2
// beyond.  A needle of up to 1024 bytes goes by value from `pat`, a host
// pointer; a longer one from `pat_dev`, on the card.  Launches on `stream`
// and returns cudaGetLastError() (0 when it launched).
extern "C" int contains_launch(const void* chars, const void* lens,
                               long long rows, int W, int R, int stride,
                               int stages, int grid, int threads, int smem,
                               int path, const void* pat, const void* pat_dev,
                               int k, void* out, void* stream) {
  const int k_max = path == PATH_SHIFT_AND32 ? 32
                    : path == PATH_SHIFT_AND64 ? CT_SHIFT_AND_MAX : W;
  const int k_min = path == PATH_LONG ? CT_SHIFT_AND_MAX + 1 : 1;
  const long long table = path == PATH_SHIFT_AND32 ? 256 * 4
                          : path == PATH_SHIFT_AND64 ? 256 * 8 : 0;
  if (rows < 1 || W < 8 || (W & (W - 1)) != 0 || R < 1 || R > threads ||
      threads > CT_MAX_THREADS || threads % 32 != 0 || stride % 16 != 0 ||
      stride < (W < 16 ? 16 : W) || stages < 1 || stages > 2 || grid < 1 ||
      table + (long long)stages * R * stride > smem || smem > CT_SMEM_MAX ||
      path < 0 || path > 2 || k < k_min || k > k_max || k > W ||
      (k <= CT_NEEDLE_BYTES ? pat == nullptr : pat_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = setup_once();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned char* c = reinterpret_cast<const unsigned char*>(chars);
  const int32_t* l = reinterpret_cast<const int32_t*>(lens);
  unsigned char* o = reinterpret_cast<unsigned char*>(out);
  Needle nd;
  memset(nd.b, 0, sizeof(nd.b));
  if (k <= CT_NEEDLE_BYTES) memcpy(nd.b, pat, k);
  if (path == PATH_LONG)
    contains_long<<<grid, threads, smem, s>>>(
        c, l, rows, W, R, stride, stages, nd,
        reinterpret_cast<const unsigned char*>(pat_dev), k, o);
  else if (path == PATH_SHIFT_AND32)
    contains_shift_and<unsigned int><<<grid, threads, smem, s>>>(
        c, l, rows, W, R, stride, stages, nd, k, o);
  else
    contains_shift_and<unsigned long long><<<grid, threads, smem, s>>>(
        c, l, rows, W, R, stride, stages, nd, k, o);
  return (int)cudaGetLastError();
}

extern "C" const char* contains_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
