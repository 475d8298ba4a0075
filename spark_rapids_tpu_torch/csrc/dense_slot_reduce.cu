// Dense-slot group-by reduction for Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_tpu/exec/pallas_agg.py:_pallas_reduce
// (pallas_call at :182), with the contract its plain form _xla_reduce (:192)
// states: for each of n planes, out[k] = add|min|max of plane[r] over the
// rows r with gid[r] == k, for k in [0, K).  K <= 1024.  Rows whose gid
// lies outside [0, K) are ignored, as there and in the plain PyTorch
// version.  Slots no row hits keep the op's neutral (0, the type's max, the
// type's min; +-inf for floats).  Float min/max propagate NaN, as
// jnp.min/jnp.max do.
//
// What bounds it.  At the main path's shape (hash_agg_sort_2m's
// group_by(k).agg(count(v), sum(v), max(w)) on a 2^20-row batch, K = 1024)
// make_update passes eight planes: occupancy i32 add, count i32 add, sum f64
// add, the sum's count i32 add, max f32 max, has-NaN and has-non-NaN i32 max
// and the max's count i32 add.  With gid the kernel must read 40 B a row,
// about 41.9 MB, and does one atomic a row per plane, far below the card's
// operation rate.  So it is bound by bytes: 41.9 MB / 3.35 TB/s = 12.5 us on
// an H100 SXM (the card's name and power limit come from nvidia-smi;
// chip_smoke.py computes the bound from the rate of the card it runs on).
//
// Design.  The TPU kernel walks 256-row blocks in sequence and accumulates
// its (K,) outputs in place, which only works because TPU grid steps run in
// order.  Here blocks run in parallel, so:
//   1. dsr_partial: a grid-stride loop over rows, a few blocks per SM.  Each
//      block keeps its (K x n) accumulators in shared memory, initialised to
//      the neutrals, and applies one shared-memory atomic per row and plane.
//      It then writes its accumulators to a (blocks, K) scratch per plane.
//   2. dsr_final: one thread per (slot, plane) reduces the scratch over the
//      blocks in block order, so the cross-block float order is fixed and no
//      global float CAS is needed.
// int64 add wraps like Java (unsigned atomicAdd); float min/max are CAS
// loops that compare values, so -0.0 and 0.0 compare equal.  The caller
// splits a spec whose accumulators pass the shared-memory budget into plane
// groups, one call each.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define DSR_MAX_PLANES 32

enum { KIND_I32 = 0, KIND_I64 = 1, KIND_F32 = 2, KIND_F64 = 3 };
enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };

struct Planes {
  const void* in[DSR_MAX_PLANES];
  void* part[DSR_MAX_PLANES];
  void* out[DSR_MAX_PLANES];
  int kind[DSR_MAX_PLANES];
  int op[DSR_MAX_PLANES];
  int smem_off[DSR_MAX_PLANES];
  int n;
};

__host__ __device__ static inline int kind_bytes(int kind) {
  return (kind == KIND_I64 || kind == KIND_F64) ? 8 : 4;
}

// ---- neutrals --------------------------------------------------------------

template <typename T> __device__ inline T neutral(int op);
template <> __device__ inline int32_t neutral<int32_t>(int op) {
  return op == OP_ADD ? 0 : (op == OP_MIN ? INT32_MAX : INT32_MIN);
}
template <> __device__ inline long long neutral<long long>(int op) {
  return op == OP_ADD ? 0LL : (op == OP_MIN ? LLONG_MAX : LLONG_MIN);
}
template <> __device__ inline float neutral<float>(int op) {
  return op == OP_ADD ? 0.0f : (op == OP_MIN ? INFINITY : -INFINITY);
}
template <> __device__ inline double neutral<double>(int op) {
  return op == OP_ADD ? 0.0 : (op == OP_MIN ? (double)INFINITY
                                            : -(double)INFINITY);
}

// ---- combine (used by the final pass) --------------------------------------

// v replaces cur under min/max: NaN wins over a number, as jnp.min/max do
template <typename T> __device__ inline bool replaces(T v, T cur, int op) {
  if (isnan(v)) return !isnan(cur);
  if (isnan(cur)) return false;
  return op == OP_MIN ? v < cur : v > cur;
}

__device__ inline int32_t combine(int32_t a, int32_t b, int op) {
  if (op == OP_ADD) return (int32_t)((uint32_t)a + (uint32_t)b);
  return op == OP_MIN ? min(a, b) : max(a, b);
}
__device__ inline long long combine(long long a, long long b, int op) {
  if (op == OP_ADD)
    return (long long)((unsigned long long)a + (unsigned long long)b);
  return op == OP_MIN ? min(a, b) : max(a, b);
}
__device__ inline float combine(float a, float b, int op) {
  if (op == OP_ADD) return a + b;
  return replaces(b, a, op) ? b : a;
}
__device__ inline double combine(double a, double b, int op) {
  if (op == OP_ADD) return a + b;
  return replaces(b, a, op) ? b : a;
}

// ---- shared-memory atomics (used by the partial pass) ----------------------

__device__ inline void atomic_apply(int32_t* p, int32_t v, int op) {
  if (op == OP_ADD) atomicAdd(p, v);
  else if (op == OP_MIN) atomicMin(p, v);
  else atomicMax(p, v);
}
__device__ inline void atomic_apply(long long* p, long long v, int op) {
  if (op == OP_ADD)
    atomicAdd(reinterpret_cast<unsigned long long*>(p),
              (unsigned long long)v);
  else if (op == OP_MIN) atomicMin(p, v);
  else atomicMax(p, v);
}
__device__ inline void atomic_apply(float* p, float v, int op) {
  if (op == OP_ADD) { atomicAdd(p, v); return; }
  unsigned int* a = reinterpret_cast<unsigned int*>(p);
  unsigned int old = *a;
  while (replaces(v, __uint_as_float(old), op)) {
    unsigned int assumed = old;
    old = atomicCAS(a, assumed, __float_as_uint(v));
    if (old == assumed) break;
  }
}
__device__ inline void atomic_apply(double* p, double v, int op) {
  if (op == OP_ADD) { atomicAdd(p, v); return; }
  unsigned long long* a = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *a;
  while (replaces(v, __longlong_as_double(old), op)) {
    unsigned long long assumed = old;
    old = atomicCAS(a, assumed, __double_as_longlong(v));
    if (old == assumed) break;
  }
}

// ---- kernels ---------------------------------------------------------------

template <typename T>
__device__ inline void init_plane(unsigned char* base, int K, int op) {
  T* acc = reinterpret_cast<T*>(base);
  T v = neutral<T>(op);
  for (int k = threadIdx.x; k < K; k += blockDim.x) acc[k] = v;
}

template <typename T>
__device__ inline void store_plane(const unsigned char* base, void* part,
                                   int K) {
  const T* acc = reinterpret_cast<const T*>(base);
  T* dst = reinterpret_cast<T*>(part) + (size_t)blockIdx.x * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) dst[k] = acc[k];
}

__global__ void dsr_partial(const int32_t* __restrict__ gid, long long n,
                            int K, Planes P) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int j = 0; j < P.n; ++j) {
    unsigned char* base = smem + P.smem_off[j];
    switch (P.kind[j]) {
      case KIND_I32: init_plane<int32_t>(base, K, P.op[j]); break;
      case KIND_I64: init_plane<long long>(base, K, P.op[j]); break;
      case KIND_F32: init_plane<float>(base, K, P.op[j]); break;
      default: init_plane<double>(base, K, P.op[j]); break;
    }
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int g = gid[r];
    if ((unsigned)g >= (unsigned)K) continue;  // outside [0, K): ignored
    for (int j = 0; j < P.n; ++j) {
      unsigned char* base = smem + P.smem_off[j];
      switch (P.kind[j]) {
        case KIND_I32:
          atomic_apply(reinterpret_cast<int32_t*>(base) + g,
                       reinterpret_cast<const int32_t*>(P.in[j])[r],
                       P.op[j]);
          break;
        case KIND_I64:
          atomic_apply(reinterpret_cast<long long*>(base) + g,
                       reinterpret_cast<const long long*>(P.in[j])[r],
                       P.op[j]);
          break;
        case KIND_F32:
          atomic_apply(reinterpret_cast<float*>(base) + g,
                       reinterpret_cast<const float*>(P.in[j])[r], P.op[j]);
          break;
        default:
          atomic_apply(reinterpret_cast<double*>(base) + g,
                       reinterpret_cast<const double*>(P.in[j])[r], P.op[j]);
          break;
      }
    }
  }
  __syncthreads();
  for (int j = 0; j < P.n; ++j) {
    const unsigned char* base = smem + P.smem_off[j];
    switch (P.kind[j]) {
      case KIND_I32: store_plane<int32_t>(base, P.part[j], K); break;
      case KIND_I64: store_plane<long long>(base, P.part[j], K); break;
      case KIND_F32: store_plane<float>(base, P.part[j], K); break;
      default: store_plane<double>(base, P.part[j], K); break;
    }
  }
}

template <typename T>
__device__ inline void final_plane(const void* part, void* out, int K,
                                   int blocks, int k, int op) {
  const T* src = reinterpret_cast<const T*>(part);
  T acc = src[k];
  for (int b = 1; b < blocks; ++b) acc = combine(acc, src[(size_t)b * K + k],
                                                 op);
  reinterpret_cast<T*>(out)[k] = acc;
}

__global__ void dsr_final(int K, int blocks, Planes P) {
  const int j = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K || j >= P.n) return;
  switch (P.kind[j]) {
    case KIND_I32: final_plane<int32_t>(P.part[j], P.out[j], K, blocks, k,
                                        P.op[j]); break;
    case KIND_I64: final_plane<long long>(P.part[j], P.out[j], K, blocks, k,
                                          P.op[j]); break;
    case KIND_F32: final_plane<float>(P.part[j], P.out[j], K, blocks, k,
                                      P.op[j]); break;
    default: final_plane<double>(P.part[j], P.out[j], K, blocks, k,
                                 P.op[j]); break;
  }
}

// ---- C interface -----------------------------------------------------------

// Reduces n_planes planes of n rows by gid into outs[j] (K,), using parts[j]
// (blocks * K,) as scratch.  kinds: 0 i32, 1 i64, 2 f32, 3 f64; ops: 0 add,
// 1 min, 2 max.  Launches both passes on `stream` and returns
// cudaGetLastError() (0 when both launched).
extern "C" int dense_slot_reduce(const void* gid, long long n, int K,
                                 int n_planes, const void* const* ins,
                                 void* const* parts, void* const* outs,
                                 const int* kinds, const int* ops, int blocks,
                                 int threads, void* stream) {
  if (n_planes < 1 || n_planes > DSR_MAX_PLANES || K < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  Planes P;
  int off = 0;
  for (int j = 0; j < n_planes; ++j) {
    P.in[j] = ins[j];
    P.part[j] = parts[j];
    P.out[j] = outs[j];
    P.kind[j] = kinds[j];
    P.op[j] = ops[j];
    P.smem_off[j] = off;
    off += (K * kind_bytes(kinds[j]) + 15) / 16 * 16;
  }
  P.n = n_planes;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      dsr_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, off);
  if (e != cudaSuccess) return (int)e;
  dsr_partial<<<blocks, threads, off, s>>>(
      reinterpret_cast<const int32_t*>(gid), n, K, P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dsr_final<<<dim3((K + 255) / 256, n_planes), 256, 0, s>>>(K, blocks, P);
  return (int)cudaGetLastError();
}

extern "C" const char* dense_slot_reduce_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
