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
// What bounds it.  One comparison chain per window, most of them ending at
// the first byte, is a few operations a byte: far below the card's rate.  So
// it is bound by bytes.  At the main path's shape (a 2^20-row batch of
// l_comment, W = 64, k = 16) the full planes are 67.1 MB of chars, 4.2 MB of
// lengths and 1.0 MB of output; the bytes a match can need are fewer, since
// only the first len[r] bytes of a row with len[r] >= k take part.
// chip_smoke.py computes the bound from the data it runs and the rate of the
// card it runs on.
//
// Design.  The TPU kernel loops over window starts j and compares a
// (rows, k) slice of the whole block at once.  Here a warp takes a group of
// R = min(32, 512 / W) consecutive rows (one row when W >= 512): R * W
// contiguous bytes that the 32 lanes stage into shared memory with 16-byte
// loads, so the reads coalesce (8-byte loads for the last 8 bytes when
// W = 8 and the row count is odd).  When W >= 512 only the bytes up to the
// row's length, rounded up to 16, are staged.  The needle sits in shared
// memory too.  Then for each row of the group lane t tests windows
// j = t, t + 32, ... up to len - k, each with an early-exit byte compare;
// __any_sync gives the row's answer, lane i keeps row i's, and the lanes
// write the group's answers as consecutive bytes.  One thread per row
// walking its own row was not taken: adjacent threads would read addresses
// W bytes apart.

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

__global__ void contains_rows(const unsigned char* __restrict__ chars,
                              const int32_t* __restrict__ lens, long long rows,
                              int W, int R, const unsigned char* __restrict__ pat,
                              int k, unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pat_pad = (k + 15) & ~15;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  unsigned char* spat = smem;
  unsigned char* stage = smem + pat_pad + (size_t)warp * R * W;
  for (int i = threadIdx.x; i < k; i += blockDim.x) spat[i] = pat[i];
  __syncthreads();

  const long long groups = (rows + R - 1) / R;
  for (long long g = (long long)blockIdx.x * warps + warp; g < groups;
       g += (long long)gridDim.x * warps) {
    const long long r0 = g * R;
    const int nrows = (int)(rows - r0 < R ? rows - r0 : R);
    int len = 0;  // lane i < nrows: the length of row r0 + i
    if (lane < nrows) {
      len = lens[r0 + lane];
      len = len < 0 ? 0 : (len > W ? W : len);
    }
    int bytes = nrows * W;
    if (R == 1) bytes = min(W, (__shfl_sync(FULL_MASK, len, 0) + 15) & ~15);
    const unsigned char* src = chars + r0 * W;
    for (int off = lane * 16; off < bytes; off += 32 * 16) {
      if (off + 16 <= bytes)
        *reinterpret_cast<uint4*>(stage + off) =
            *reinterpret_cast<const uint4*>(src + off);
      else
        *reinterpret_cast<uint2*>(stage + off) =
            *reinterpret_cast<const uint2*>(src + off);
    }
    __syncwarp();

    bool mine = false;
    for (int i = 0; i < nrows; ++i) {
      const int last = __shfl_sync(FULL_MASK, len, i) - k;
      const unsigned char* row = stage + i * W;
      bool hit = false;
      for (int j = lane; j <= last && !hit; j += 32) {
        int t = 0;
        while (t < k && row[j + t] == spat[t]) ++t;
        hit = (t == k);
      }
      const bool any = __any_sync(FULL_MASK, hit);
      if (lane == i) mine = any;
    }
    if (lane < nrows) out[r0 + lane] = mine ? 1 : 0;
    __syncwarp();  // the next group overwrites the stage
  }
}

// ---- C interface -----------------------------------------------------------

// out[r] (one byte, 0 or 1) for r in [0, rows): whether the k-byte needle
// pat occurs in row r of the (rows, W) char matrix before len[r].  R rows a
// warp, `threads` threads a block (a multiple of 32), `smem` bytes of
// dynamic shared memory: the needle rounded up to 16 plus R * W a warp.
// Launches on `stream` and returns cudaGetLastError() (0 when it launched).
extern "C" int contains_launch(const void* chars, const void* lens,
                               long long rows, int W, int R, const void* pat,
                               int k, void* out, int blocks, int threads,
                               int smem, void* stream) {
  if (rows < 1 || W < 8 || (W & (W - 1)) != 0 || R < 1 || R > 32 || k < 1 ||
      k > W || blocks < 1 || threads < 32 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      contains_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  contains_rows<<<blocks, threads, smem,
                  reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const unsigned char*>(chars),
      reinterpret_cast<const int32_t*>(lens), rows, W, R,
      reinterpret_cast<const unsigned char*>(pat), k,
      reinterpret_cast<unsigned char*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* contains_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
