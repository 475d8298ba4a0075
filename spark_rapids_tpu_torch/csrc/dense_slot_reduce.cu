// Dense-slot group-by reduction for Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_tpu/exec/pallas_agg.py:_pallas_reduce
// (pallas_call at :182), with the contract its plain form _xla_reduce (:192)
// states: for each of n planes, out[k] = add|min|max of plane[r] over the
// rows r with gid[r] == k, for k in [0, K).  K <= 1024.  Rows whose gid
// lies outside [0, K) are ignored, as there and in the plain PyTorch
// version.  Slots no row hits keep the op's neutral (0, the type's max, the
// type's min; +-inf for floats).  Float min/max propagate NaN, as
// jnp.min/jnp.max do; int64 add wraps as Java's does.
//
// What bounds it.  At the main path's shape (hash_agg_sort_2m's
// group_by(k).agg(count(v), sum(v), max(w)) on a 2^20-row batch, K = 1024)
// make_update passes eight planes: occupancy i32 add, count i32 add, sum f64
// add, the sum's count i32 add, max f32 max, has-NaN and has-non-NaN i32 max
// and the max's count i32 add.  With gid the kernel must read 40 B a row,
// 41.98 MB, and does one shared-memory atomic a row per plane, far below
// the card's operation rate.  So it is bound by bytes: 41.98 MB / 3.35 TB/s
// = 12.5 us on an H100 SXM (chip_smoke.py computes the bound from the rate
// of the card it runs on).
//
// Design:
//   1. dsr_init sets every (K,) output of an integer plane or a float
//      min/max plane to its op's neutral.
//   2. dsr_reduce: one block of 1024 threads an SM keeps (K x n)
//      accumulators in shared memory.  It takes tiles of 8 * 1024 rows in
//      turn; a thread holds 8 gids of a tile in registers (two 16-byte
//      loads), then for each plane resolves the (kind, op) once and runs a
//      row loop specialised for it: two or four 16-byte loads (scalar loads
//      when a plane is not 16-byte aligned, and for the ragged last tile),
//      then one shared-memory atomic a row.  Float min/max map the value to
//      an ordered unsigned integer (all bits flipped for a negative float,
//      the sign bit set for a positive one) and take native unsigned
//      atomicMin/atomicMax; a NaN maps to the end of the order that wins
//      under the op and decodes to a quiet NaN, so NaN wins, as in the
//      plain version.
//      Under that order +0.0 > -0.0: when both occur, max returns +0.0 and
//      min -0.0 (they compare equal to the plain version's).  The block
//      then merges its accumulators into the outputs with one global
//      atomic a (slot, plane), skipping slots still at the neutral: native
//      RED for integers; float min/max split on the sign bit (signed max
//      or unsigned min of the bits for max, the converse for min), so no
//      CAS loop.  Integer adds and every min/max are exact in any order.
//   3. Float adds take a fixed order instead, so a float sum comes out bit
//      for bit the same on every call on a given card (a query may compare
//      two evaluations of one sum for equality, as TPC-H Q15 does).  The
//      order mirrors the TPU kernel's, which sums each grid step's rows
//      and adds the steps in sequence.  dsr_fsum: blocks of 512 threads
//      take tiles of 16 * 512 rows in a fixed assignment (block b takes
//      tiles b, b + grid, ...); warp w of a block takes 16 runs of 32
//      consecutive rows of each tile, in order, their loads all in flight
//      together.  In a run, the lanes whose rows share a slot find each
//      other (__match_any_sync); the group's lowest lane sums the group's
//      values in lane order, read from a staging row in shared memory,
//      and adds the sum into its warp's own (K,) accumulator in shared
//      memory, which no other warp writes.  At the end the block
//      adds its 16 warps' accumulators in warp order into its row of a
//      (grid, K) scratch.  dsr_fsum_final adds each slot's grid partials
//      in a fixed order (strided by 32, then a tree over the 32 strands).
//      A warp's accumulators take 16 * K * 8 bytes a f64 plane (128 KB at
//      K = 1024), so the float-add planes go in passes of as many as fit
//      one block's shared memory.
// The caller splits a spec whose accumulators pass the shared-memory
// budget into plane groups, one call each.
//
// What bounds dsr_reduce is the shared-memory atomics: one a row and
// plane, at random slots, so a warp's 32 atomics meet bank conflicts; the
// SASS has native ATOMS for 32-bit integers and for the ordered float
// min/max.  dsr_fsum does no atomic: a 32-row run costs one match, one
// staging store and, in each leader, as many shared loads and adds as its
// group has rows.  Times on the card are in PERF.md.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#define DSR_MAX_PLANES 32
#define DSR_ROWS 8            // rows a thread takes from each tile
#define DSR_SMEM_MAX 232448   // bytes of shared memory a Hopper block may use
#define DSR_MAX_DEVICES 64
#define FS_THREADS 512        // threads a block of dsr_fsum
#define FS_WARPS (FS_THREADS / 32)
#define FS_ROWS 16            // 32-row runs a warp takes from each tile
#define FS_UNROLL 16          // runs whose loads are in flight together
#define FS_STAGE_BYTES (FS_WARPS * 32 * 8)  // a staging row a warp

enum { KIND_I32 = 0, KIND_I64 = 1, KIND_F32 = 2, KIND_F64 = 3 };
enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };

static bool is_fadd(int kind, int op) {
  return op == OP_ADD && (kind == KIND_F32 || kind == KIND_F64);
}

struct Planes {
  const void* in[DSR_MAX_PLANES];
  void* out[DSR_MAX_PLANES];
  int kind[DSR_MAX_PLANES];
  int op[DSR_MAX_PLANES];
  int smem_off[DSR_MAX_PLANES];  // the plane's accumulators
  int n;
};

// One pass of dsr_fsum: float-add planes, each with its (grid, K) scratch
// of block partials.
struct FPass {
  const void* in[DSR_MAX_PLANES];
  void* part[DSR_MAX_PLANES];
  void* out[DSR_MAX_PLANES];
  int kind[DSR_MAX_PLANES];      // KIND_F32 or KIND_F64
  int smem_off[DSR_MAX_PLANES];  // FS_WARPS accumulators of K slots
  int smem_bytes;
  int n;
};

static int kind_bytes(int kind) {
  return (kind == KIND_I64 || kind == KIND_F64) ? 8 : 4;
}

// ---- float order as unsigned integers --------------------------------------

__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ unsigned long long ordered(double f) {
  const unsigned long long u = (unsigned long long)__double_as_longlong(f);
  return (u >> 63) ? ~u : (u | 0x8000000000000000ull);
}
__device__ __forceinline__ float unordered(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
__device__ __forceinline__ double unordered(unsigned long long u) {
  return __longlong_as_double(
      (long long)((u >> 63) ? (u & 0x7fffffffffffffffull) : ~u));
}

// ---- how each (type, op) accumulates ---------------------------------------
//
// S is the shared-memory accumulator's type; enc maps a value to it, smem
// and global apply it with atomics, and out_neutral is the output's
// starting value.

template <typename In, int OP> struct Acc;

template <int OP> struct Acc<int32_t, OP> {
  typedef int32_t S;
  static __device__ __forceinline__ S neutral() {
    return OP == OP_ADD ? 0 : (OP == OP_MIN ? INT32_MAX : INT32_MIN);
  }
  static __device__ __forceinline__ int32_t out_neutral() { return neutral(); }
  static __device__ __forceinline__ S enc(int32_t v) { return v; }
  static __device__ __forceinline__ void smem(S* p, S v) {
    if (OP == OP_ADD) atomicAdd(p, v);
    else if (OP == OP_MIN) atomicMin(p, v);
    else atomicMax(p, v);
  }
  static __device__ __forceinline__ void global(int32_t* p, S v) { smem(p, v); }
};

template <int OP> struct Acc<long long, OP> {
  typedef long long S;
  static __device__ __forceinline__ S neutral() {
    return OP == OP_ADD ? 0LL : (OP == OP_MIN ? LLONG_MAX : LLONG_MIN);
  }
  static __device__ __forceinline__ long long out_neutral() { return neutral(); }
  static __device__ __forceinline__ S enc(long long v) { return v; }
  static __device__ __forceinline__ void smem(S* p, S v) {
    if (OP == OP_ADD)
      atomicAdd(reinterpret_cast<unsigned long long*>(p),
                (unsigned long long)v);
    else if (OP == OP_MIN) atomicMin(p, v);
    else atomicMax(p, v);
  }
  static __device__ __forceinline__ void global(long long* p, S v) {
    smem(p, v);
  }
};

// float min/max: U is the ordered integer, I the signed integer of the
// same width
template <typename F, typename U, typename I, int OP> struct FloatMinMax {
  typedef U S;
  static __device__ __forceinline__ S neutral() {
    return ordered(OP == OP_MIN ? (F)INFINITY : -(F)INFINITY);
  }
  static __device__ __forceinline__ F out_neutral() {
    return OP == OP_MIN ? (F)INFINITY : -(F)INFINITY;
  }
  // a NaN takes the end of the order that wins under the op
  static __device__ __forceinline__ S enc(F v) {
    return isnan(v) ? (OP == OP_MAX ? ~(U)0 : (U)0) : ordered(v);
  }
  static __device__ __forceinline__ void smem(S* p, S v) {
    if (OP == OP_MIN) atomicMin(p, v);
    else atomicMax(p, v);
  }
  // On the output's own float bits: a non-negative float orders as its
  // signed integer, a negative one in reverse as its unsigned integer.
  static __device__ __forceinline__ void global(F* p, S v) {
    const F f = unordered(v);
    I bits;
    memcpy(&bits, &f, sizeof(F));
    if (bits >= 0) {
      if (OP == OP_MAX) atomicMax(reinterpret_cast<I*>(p), bits);
      else atomicMin(reinterpret_cast<I*>(p), bits);
    } else {
      if (OP == OP_MAX) atomicMin(reinterpret_cast<U*>(p), (U)bits);
      else atomicMax(reinterpret_cast<U*>(p), (U)bits);
    }
  }
};
template <int OP> struct Acc<float, OP>
    : FloatMinMax<float, unsigned int, int, OP> {};
template <int OP> struct Acc<double, OP>
    : FloatMinMax<double, unsigned long long, long long, OP> {};

// ---- dispatch on (kind, op), once per plane --------------------------------

template <typename T, int O> struct Spec {
  typedef T In;
  static constexpr int op = O;
};

template <typename Fn>
__device__ __forceinline__ void with_spec(int kind, int op, Fn fn) {
  switch (kind * 3 + op) {
    case 0: fn(Spec<int32_t, OP_ADD>()); break;
    case 1: fn(Spec<int32_t, OP_MIN>()); break;
    case 2: fn(Spec<int32_t, OP_MAX>()); break;
    case 3: fn(Spec<long long, OP_ADD>()); break;
    case 4: fn(Spec<long long, OP_MIN>()); break;
    case 5: fn(Spec<long long, OP_MAX>()); break;
    case 6: break;  // float adds take dsr_fsum
    case 7: fn(Spec<float, OP_MIN>()); break;
    case 8: fn(Spec<float, OP_MAX>()); break;
    case 9: break;
    case 10: fn(Spec<double, OP_MIN>()); break;
    default: fn(Spec<double, OP_MAX>()); break;
  }
}

// The thread's DSR_ROWS rows of the tile at `base`: rows
// base + h * 4 * threads + 4 * threadIdx.x + i for h in {0, 1}, i < 4, so
// each half is one 16-byte load of a 4-byte plane (two of an 8-byte one)
// and a warp's loads are contiguous.  `full`: the tile lies inside [0, n)
// and every plane is 16-byte aligned; otherwise scalar loads, and rows at
// or past n read as `fill`.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ p,
                                          T (&v)[DSR_ROWS], long long base,
                                          long long n, int threads,
                                          bool full, T fill) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r0 = base + (long long)h * 4 * threads + 4 * threadIdx.x;
    if (full) {
      const uint4* q = reinterpret_cast<const uint4*>(p + r0);
      if constexpr (sizeof(T) == 4) {
        const uint4 a = __ldg(q);
        memcpy(&v[4 * h], &a, 16);
      } else {
        const uint4 a = __ldg(q);
        const uint4 b = __ldg(q + 1);
        memcpy(&v[4 * h], &a, 16);
        memcpy(&v[4 * h + 2], &b, 16);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[4 * h + i] = r0 + i < n ? p[r0 + i] : fill;
    }
  }
}

// One shared-memory atomic a row: rows whose gid lies outside [0, K) are
// ignored.
template <typename In, int OP, int N>
__device__ __forceinline__ void apply(unsigned char* accb, const int (&g)[N],
                                      const In (&v)[N], int K) {
  typedef Acc<In, OP> A;
  typename A::S* acc = reinterpret_cast<typename A::S*>(accb);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if ((unsigned)g[i] < (unsigned)K) A::smem(acc + g[i], A::enc(v[i]));
}

// ---- kernels ---------------------------------------------------------------

__global__ void dsr_init(const __grid_constant__ Planes P, int K) {
  const int j = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P.n || k >= K) return;
  void* out = P.out[j];
  with_spec(P.kind[j], P.op[j], [&](auto s) {
    typedef typename decltype(s)::In In;
    reinterpret_cast<In*>(out)[k] = Acc<In, decltype(s)::op>::out_neutral();
  });
}

__global__ void __launch_bounds__(1024)
    dsr_reduce(const int32_t* __restrict__ gid, long long n, int K,
               const __grid_constant__ Planes P, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  for (int j = 0; j < P.n; ++j) {
    unsigned char* accb = smem + P.smem_off[j];
    with_spec(P.kind[j], P.op[j], [&](auto s) {
      typedef Acc<typename decltype(s)::In, decltype(s)::op> A;
      typename A::S* acc = reinterpret_cast<typename A::S*>(accb);
      for (int k = threadIdx.x; k < K; k += T) acc[k] = A::neutral();
    });
  }
  __syncthreads();

  const long long tile = (long long)DSR_ROWS * T;
  const long long tiles = (n + tile - 1) / tile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * tile;
    const bool full = vec && base + tile <= n;
    int g[DSR_ROWS];
    load_rows(gid, g, base, n, T, full, -1);
    for (int j = 0; j < P.n; ++j) {
      unsigned char* accb = smem + P.smem_off[j];
      const void* in = P.in[j];
      with_spec(P.kind[j], P.op[j], [&](auto s) {
        typedef typename decltype(s)::In In;
        In v[DSR_ROWS];
        load_rows(reinterpret_cast<const In*>(in), v, base, n, T, full, In(0));
        apply<In, decltype(s)::op>(accb, g, v, K);
      });
    }
  }

  __syncthreads();
  for (int j = 0; j < P.n; ++j) {
    unsigned char* accb = smem + P.smem_off[j];
    void* out = P.out[j];
    with_spec(P.kind[j], P.op[j], [&](auto s) {
      typedef typename decltype(s)::In In;
      typedef Acc<In, decltype(s)::op> A;
      typedef typename A::S S;
      const S* acc = reinterpret_cast<const S*>(accb);
      for (int k = threadIdx.x; k < K; k += T) {
        const S v = acc[k];
        if (v != A::neutral()) A::global(reinterpret_cast<In*>(out) + k, v);
      }
    });
  }
}

// ---- fixed-order float adds ------------------------------------------------

// FS_UNROLL runs of 32 rows of one plane, starting at r0: each lane's row
// r0 + 32 i + lane.  A run's values go to the warp's staging row in shared
// memory; the lowest lane of each group (grp[i], the lanes whose rows
// share slot g[i]) reads its group's values from there in lane order and
// adds their sum to the warp's accumulator.  Only the leaders loop, each
// as many times as its group has rows, and no shuffle's mask diverges.
template <typename F>
__device__ __forceinline__ void fsum_runs(F* acc, F* stage,
                                          const F* __restrict__ in,
                                          const int (&g)[FS_UNROLL],
                                          const unsigned (&grp)[FS_UNROLL],
                                          long long r0, long long n,
                                          int lane) {
  F v[FS_UNROLL];
#pragma unroll
  for (int i = 0; i < FS_UNROLL; ++i) {
    const long long r = r0 + 32LL * i + lane;
    v[i] = r < n ? in[r] : F(0);
  }
#pragma unroll
  for (int i = 0; i < FS_UNROLL; ++i) {
    stage[lane] = v[i];
    __syncwarp();
    if (g[i] >= 0 && lane == __ffs(grp[i]) - 1) {
      F s = F(0);
      for (unsigned m = grp[i]; m; m &= m - 1) s += stage[__ffs(m) - 1];
      acc[g[i]] += s;
    }
    __syncwarp();
  }
}

template <typename F>
__device__ __forceinline__ void fsum_block_partial(const F* acc, F* part,
                                                   int K) {
  for (int k = threadIdx.x; k < K; k += FS_THREADS) {
    F s = acc[k];
    for (int w = 1; w < FS_WARPS; ++w) s += acc[(long long)w * K + k];
    part[(long long)blockIdx.x * K + k] = s;
  }
}

__global__ void __launch_bounds__(FS_THREADS)
    dsr_fsum(const int32_t* __restrict__ gid, long long n, int K,
             const __grid_constant__ FPass P) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) unsigned char stage[FS_STAGE_BYTES];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wstage = stage + warp * 32 * 8;
  for (int i = threadIdx.x; i < P.smem_bytes / 4; i += FS_THREADS)
    reinterpret_cast<uint32_t*>(smem)[i] = 0u;  // +0.0 in both types
  __syncthreads();

  const long long tile = (long long)FS_ROWS * 32 * FS_WARPS;
  const long long tiles = (n + tile - 1) / tile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long wbase = t * tile + (long long)warp * 32 * FS_ROWS;
    for (int c = 0; c < FS_ROWS; c += FS_UNROLL) {
      const long long r0 = wbase + 32LL * c;
      int g[FS_UNROLL];
      unsigned grp[FS_UNROLL];
#pragma unroll
      for (int i = 0; i < FS_UNROLL; ++i) {
        const long long r = r0 + 32LL * i + lane;
        const int x = r < n ? gid[r] : -1;
        g[i] = (unsigned)x < (unsigned)K ? x : -1;
      }
#pragma unroll
      for (int i = 0; i < FS_UNROLL; ++i)
        grp[i] = __match_any_sync(0xffffffffu, g[i]);
      for (int j = 0; j < P.n; ++j) {
        unsigned char* accb = smem + P.smem_off[j];
        if (P.kind[j] == KIND_F64)
          fsum_runs(reinterpret_cast<double*>(accb) + (long long)warp * K,
                    reinterpret_cast<double*>(wstage),
                    reinterpret_cast<const double*>(P.in[j]), g, grp, r0, n,
                    lane);
        else
          fsum_runs(reinterpret_cast<float*>(accb) + (long long)warp * K,
                    reinterpret_cast<float*>(wstage),
                    reinterpret_cast<const float*>(P.in[j]), g, grp, r0, n,
                    lane);
      }
    }
  }

  __syncthreads();
  for (int j = 0; j < P.n; ++j) {
    const unsigned char* accb = smem + P.smem_off[j];
    if (P.kind[j] == KIND_F64)
      fsum_block_partial(reinterpret_cast<const double*>(accb),
                         reinterpret_cast<double*>(P.part[j]), K);
    else
      fsum_block_partial(reinterpret_cast<const float*>(accb),
                         reinterpret_cast<float*>(P.part[j]), K);
  }
}

// Slot blockIdx.x * 32 + threadIdx.x of plane blockIdx.y: strand
// threadIdx.y adds the partials of blocks threadIdx.y, + 32, ... in
// order; a tree over the 32 strands, in a fixed shape, gives the sum.
template <typename F>
__device__ __forceinline__ void fsum_final_plane(const F* __restrict__ part,
                                                 F* out, int K, int blocks,
                                                 unsigned char* buf) {
  F* red = reinterpret_cast<F*>(buf);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k = blockIdx.x * 32 + tx;
  F s = F(0);
  if (k < K)
    for (int b = ty; b < blocks; b += 32) s += part[(long long)b * K + k];
  red[ty * 33 + tx] = s;
  __syncthreads();
  for (int h = 16; h > 0; h >>= 1) {
    if (ty < h) red[ty * 33 + tx] += red[(ty + h) * 33 + tx];
    __syncthreads();
  }
  if (ty == 0 && k < K) out[k] = red[tx];
}

__global__ void __launch_bounds__(1024)
    dsr_fsum_final(int K, int blocks, const __grid_constant__ FPass P) {
  __shared__ __align__(8) unsigned char buf[32 * 33 * sizeof(double)];
  const int j = blockIdx.y;
  if (P.kind[j] == KIND_F64)
    fsum_final_plane(reinterpret_cast<const double*>(P.part[j]),
                     reinterpret_cast<double*>(P.out[j]), K, blocks, buf);
  else
    fsum_final_plane(reinterpret_cast<const float*>(P.part[j]),
                     reinterpret_cast<float*>(P.out[j]), K, blocks, buf);
}

// ---- C interface -----------------------------------------------------------

// Each kernel's largest dynamic shared memory, set once a device.
static cudaError_t setup_once() {
  static bool ready[DSR_MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < DSR_MAX_DEVICES && ready[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(dsr_reduce,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DSR_SMEM_MAX);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dsr_fsum,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DSR_SMEM_MAX - FS_STAGE_BYTES);
  if (e != cudaSuccess) return e;
  if (dev < DSR_MAX_DEVICES) ready[dev] = true;
  return cudaSuccess;
}

// The float-add planes of a call, in passes of as many as fit one block's
// shared memory, each pass dsr_fsum then dsr_fsum_final.
static cudaError_t launch_fsum(const int32_t* gid, long long n, int K,
                               const FPass& all, int fsum_grid,
                               cudaStream_t s) {
  // the staging rows are static shared memory beside the accumulators
  const int budget = DSR_SMEM_MAX - FS_STAGE_BYTES;
  if (FS_WARPS * ((K * 8 + 15) / 16 * 16) > budget)
    return cudaErrorInvalidValue;
  int j = 0;
  while (j < all.n) {
    FPass P;
    P.n = 0;
    int off = 0;
    while (j < all.n) {
      const int bytes =
          FS_WARPS * ((K * kind_bytes(all.kind[j]) + 15) / 16 * 16);
      if (P.n > 0 && off + bytes > budget) break;
      P.in[P.n] = all.in[j];
      P.part[P.n] = all.part[j];
      P.out[P.n] = all.out[j];
      P.kind[P.n] = all.kind[j];
      P.smem_off[P.n] = off;
      off += bytes;
      ++P.n;
      ++j;
    }
    P.smem_bytes = off;
    dsr_fsum<<<fsum_grid, FS_THREADS, off, s>>>(gid, n, K, P);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dsr_fsum_final<<<dim3((K + 31) / 32, P.n), dim3(32, 32), 0, s>>>(
        K, fsum_grid, P);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Reduces n_planes planes of n rows by gid into outs[j] (K,).  kinds: 0 i32,
// 1 i64, 2 f32, 3 f64; ops: 0 add, 1 min, 2 max.  parts[j]: a (fsum_grid,
// K) scratch of the plane's type for each float add, unused otherwise.
// vec: every plane and gid are 16-byte aligned.  The integer and min/max
// planes take dsr_reduce on `grid` blocks of `threads` threads, the float
// adds dsr_fsum on `fsum_grid` blocks.  Launches every kernel on `stream`
// and returns cudaGetLastError() (0 when all launched).
extern "C" int dense_slot_reduce(const void* gid, long long n, int K,
                                 int n_planes, const void* const* ins,
                                 void* const* outs, const int* kinds,
                                 const int* ops, void* const* parts, int vec,
                                 int grid, int threads, int fsum_grid,
                                 void* stream) {
  if (n_planes < 1 || n_planes > DSR_MAX_PLANES || K < 1 || K > 1024 ||
      n < 0 || grid < 1 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || fsum_grid < 1)
    return (int)cudaErrorInvalidValue;
  Planes P;
  FPass F;
  P.n = F.n = 0;
  int off = 0;
  for (int j = 0; j < n_planes; ++j) {
    if (kinds[j] < 0 || kinds[j] > 3 || ops[j] < 0 || ops[j] > 2)
      return (int)cudaErrorInvalidValue;
    if (is_fadd(kinds[j], ops[j])) {
      if (parts[j] == nullptr) return (int)cudaErrorInvalidValue;
      F.in[F.n] = ins[j];
      F.part[F.n] = parts[j];
      F.out[F.n] = outs[j];
      F.kind[F.n] = kinds[j];
      ++F.n;
      continue;
    }
    P.in[P.n] = ins[j];
    P.out[P.n] = outs[j];
    P.kind[P.n] = kinds[j];
    P.op[P.n] = ops[j];
    P.smem_off[P.n] = off;
    off += (K * kind_bytes(kinds[j]) + 15) / 16 * 16;
    ++P.n;
  }
  if (off > DSR_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = setup_once();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (P.n > 0) {
    dsr_init<<<dim3((K + 255) / 256, P.n), 256, 0, s>>>(P, K);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dsr_reduce<<<grid, threads, off, s>>>(
        reinterpret_cast<const int32_t*>(gid), n, K, P, vec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (F.n > 0) {
    e = launch_fsum(reinterpret_cast<const int32_t*>(gid), n, K, F,
                    fsum_grid, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

extern "C" const char* dense_slot_reduce_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
