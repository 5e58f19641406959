// Sparse DecAvg gossip C = W @ P on Hopper (sm_90a), W stored as ELL, f32
// accumulation, output in P's dtype. Two kernels, two layouts:
//
// 1. sparse_gossip_blocked (replaces repro/kernels/sparse_gossip.py::
//    sparse_gossip_blocked_pallas): the 8-row-blocked ELL layout of
//    core/sparse.block_ell_from_csr. For destination block b (rows 8b..8b+7)
//    and each tile slot s, idx[b, s] names a source block and
//    val[8b:8b+8, 8s:8s+8] holds the (8, 8) weights coupling the two:
//        out[8b + r, :] = sum_s sum_o val[8b + r, 8s + o] * P[8 idx[b, s] + o, :]
// 2. sparse_gossip (replaces sparse_gossip_pallas): the scalar ELL row
//    gather of core/sparse.ell_from_csr:
//        out[i, :] = sum_k val[i, k] * P[idx[i, k], :]
//
// What bounds them on this card: both are bound by bytes. At the large_n
// preset's size (N = 1024, the 784-64-10 MLP, 50,890 values a node over 4
// leaves) one gossip round must read P and write C once, 2 x 1024 x 50,890
// x 4 B = 417 MB, about 0.124 ms at 3.35 TB/s, while its multiply-adds (2
// per W entry per column, about 9-13 entries a row) take about 0.014 ms at
// the 67 TFLOP/s f32 rate of the CUDA cores. So the design is about reading
// P as few times as possible and never reading padding:
//
// - One block per (destination row or 8-row block, 512-column slab of D); a
//   thread owns 4 neighbouring columns and moves them with one 16-byte load
//   (8 bytes for bf16) when D % 4 == 0. The TPU kernel's sequential k grid
//   axis and its VMEM accumulator become a loop over the row's slots inside
//   the block and an accumulator in registers (8 x 4 floats for the blocked
//   kernel, 4 for the row gather). Blocks run b fastest, so blocks in
//   flight share a slab and, on graphs whose neighbours are near in index
//   (ring lattices, tori, cliques), the same source rows in L2.
// - The slots are summed in their fixed order with fmaf: no atomics, so the
//   result is the same on every run.
// - Padding is not paid for. The blocked layout pads each block's slot
//   count to a multiple of 16 with all-zero tiles (TPU lane alignment),
//   which is 70% of the slots on the ws graph and 81% on caveman, and a
//   real tile holds weights in only some of its 8 columns (2.3 of 8 on ws).
//   A block stages 16 tiles in shared memory at a time with a mask of each
//   tile's non-zero columns, and reads only the source rows of those
//   columns: on ws 2,864 rows a slab, against 9,760 for every row of every
//   real tile and 9,216 for the row gather, which must read each neighbour
//   once per destination row. The row gather skips zero-weight slots. Each
//   skip is exact: a zero weight adds an exact zero (for finite P).
// - Latency: the blocked kernel issues the loads of a tile's active columns
//   before their FMAs, so they are in flight together.
// - Ragged N (not a multiple of 8) and ragged D are masked here: source
//   rows past N are never read (their weights are zero) and outputs past
//   N or D are never written. Nothing is padded on the host.
// - f32 FMAs on the CUDA cores, not TF32 tensor cores: the reference's
//   tolerance is 3e-5 and TF32 keeps about 1e-3.
// - The indices are trusted to lie in [0, N): they come from the layout
//   builders, and checking them would cost a device-to-host sync a round.
//
// Offsets into P and C are int64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;         // threads per block
constexpr int SLAB = THREADS * 4;    // columns of D per block
constexpr int BR = 8;                // rows per block of the blocked layout
constexpr int STAGE = 16;            // blocked layout: tiles staged per round trip

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float4 load4(const float* src) {
  return __ldg(reinterpret_cast<const float4*>(src));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

// The thread's 4 columns of one row of P, as f32; 0 past D.
// V4: columns c..c+3 with c = slab0 + 4 tid (D % 4 == 0, so all or none).
// Otherwise: columns slab0 + tid + j THREADS, j = 0..3 (coalesced scalars).
template <typename T, bool V4>
__device__ __forceinline__ void load_cols(float (&x)[4], const T* __restrict__ row,
                                          int64_t slab0, int tid, int64_t d) {
  if (V4) {
    const int64_t c = slab0 + 4 * tid;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < d) v = load4(row + c);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = slab0 + tid + j * THREADS;
      x[j] = c < d ? to_f32(row[c]) : 0.f;
    }
  }
}

template <typename T, bool V4>
__device__ __forceinline__ void store_cols(T* __restrict__ row, const float (&acc)[4],
                                           int64_t slab0, int tid, int64_t d) {
  if (V4) {
    const int64_t c = slab0 + 4 * tid;
    if (c < d) store4(row + c, acc);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = slab0 + tid + j * THREADS;
      if (c < d) store1(row + c, acc[j]);
    }
  }
}

// Scalar ELL row gather: block (i, slab) computes out[i, slab], one slot
// after another. At about 30 registers a thread an SM holds its maximum of
// 16 blocks, and that occupancy hides the load latency: a version that
// issued 8 slots' loads before their FMAs ran 14-21% slower on the large_n
// layouts on an H100.
template <typename T, bool V4>
__global__ void __launch_bounds__(THREADS)
ell_gather_kernel(const int32_t* __restrict__ idx, const float* __restrict__ val,
                  const T* __restrict__ p, T* __restrict__ out, int64_t k, int64_t d) {
  const int64_t i = blockIdx.x;
  const int64_t slab0 = static_cast<int64_t>(blockIdx.y) * SLAB;
  const int tid = threadIdx.x;
  const int32_t* irow = idx + i * k;
  const float* vrow = val + i * k;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t s = 0; s < k; ++s) {
    const float w = __ldg(vrow + s);  // uniform across the block
    if (w == 0.f) continue;           // padded slot: an exact zero, never read
    float x[4];
    load_cols<T, V4>(x, p + static_cast<int64_t>(__ldg(irow + s)) * d, slab0, tid, d);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = fmaf(w, x[j], acc[j]);
  }
  store_cols<T, V4>(out + i * d, acc, slab0, tid, d);
}

// 8-row-blocked ELL: block (b, slab) computes out[8b:8b+8, slab]. Tiles go
// in chunks of STAGE: the chunk's (8, 8) weight tiles and source-block ids
// are staged in shared memory together (three barriers a chunk), with a
// mask per tile of its columns (source rows) that hold a weight. Then, tile
// by tile, the rows of its active columns are loaded, all in flight
// together, and their FMAs run in column order. All-zero tiles (the lane
// padding) and all-zero columns are never read: they would add exact zeros.
template <typename T, bool V4>
__global__ void __launch_bounds__(THREADS)
blocked_ell_kernel(const int32_t* __restrict__ idx, const float* __restrict__ val,
                   const T* __restrict__ p, T* __restrict__ out, int64_t n, int64_t kb,
                   int64_t d) {
  __shared__ float tiles[STAGE][BR][BR];
  __shared__ int32_t src_blk[STAGE];
  __shared__ uint32_t col_mask[STAGE];
  const int64_t b = blockIdx.x;
  const int64_t slab0 = static_cast<int64_t>(blockIdx.y) * SLAB;
  const int tid = threadIdx.x;
  const int64_t val_ld = kb * BR;
  float acc[BR][4];
#pragma unroll
  for (int r = 0; r < BR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int64_t s0 = 0; s0 < kb; s0 += STAGE) {
    const int ch = static_cast<int>(kb - s0 < STAGE ? kb - s0 : STAGE);
    __syncthreads();  // every thread is done with the previous chunk
    for (int e = tid; e < ch * BR * BR; e += THREADS) {
      const int t = e / (BR * BR), r = (e / BR) % BR, o = e % BR;
      tiles[t][r][o] = __ldg(val + (b * BR + r) * val_ld + (s0 + t) * BR + o);
    }
    if (tid < ch) src_blk[tid] = __ldg(idx + b * kb + s0 + tid);
    __syncthreads();
    if (tid < ch) {
      uint32_t m = 0;
#pragma unroll
      for (int r = 0; r < BR; ++r)
#pragma unroll
        for (int o = 0; o < BR; ++o) m |= (tiles[tid][r][o] != 0.f) ? (1u << o) : 0u;
      col_mask[tid] = m;
    }
    __syncthreads();
    for (int t = 0; t < ch; ++t) {
      const uint32_t m = col_mask[t];  // uniform across the block
      if (m == 0) continue;
      const int64_t src0 = static_cast<int64_t>(src_blk[t]) * BR;
      float x[BR][4];
#pragma unroll
      for (int o = 0; o < BR; ++o) {
        // Rows past N weigh 0 in the layout, so their bit is never set.
        if (((m >> o) & 1u) && src0 + o < n) {
          load_cols<T, V4>(x[o], p + (src0 + o) * d, slab0, tid, d);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) x[o][j] = 0.f;
        }
      }
#pragma unroll
      for (int o = 0; o < BR; ++o) {
        if (!((m >> o) & 1u)) continue;
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          const float w = tiles[t][r][o];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(w, x[o][j], acc[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    const int64_t row = b * BR + r;
    if (row < n) store_cols<T, V4>(out + row * d, acc[r], slab0, tid, d);
  }
}

template <typename T>
bool use_v4(const void* p, const void* c, int64_t d) {
  const uintptr_t align = 4 * sizeof(T);
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(p) % align == 0 &&
         reinterpret_cast<uintptr_t>(c) % align == 0;
}

bool grid_for(int64_t rows, int64_t d, dim3* grid) {
  const int64_t slabs = (d + SLAB - 1) / SLAB;
  if (rows > 0x7fffffff || slabs > 65535) return false;
  *grid = dim3(static_cast<unsigned>(rows), static_cast<unsigned>(slabs));
  return true;
}

template <typename T>
int launch_gather(const int32_t* idx, const float* val, const T* p, T* c, int64_t n,
                  int64_t k, int64_t d, cudaStream_t stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  dim3 grid;
  if (!grid_for(n, d, &grid)) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (use_v4<T>(p, c, d))
    ell_gather_kernel<T, true><<<grid, THREADS, 0, stream>>>(idx, val, p, c, k, d);
  else
    ell_gather_kernel<T, false><<<grid, THREADS, 0, stream>>>(idx, val, p, c, k, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_blocked(const int32_t* idx, const float* val, const T* p, T* c, int64_t n,
                   int64_t kb, int64_t d, cudaStream_t stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  dim3 grid;
  if (!grid_for((n + BR - 1) / BR, d, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (use_v4<T>(p, c, d))
    blocked_ell_kernel<T, true><<<grid, THREADS, 0, stream>>>(idx, val, p, c, n, kb, d);
  else
    blocked_ell_kernel<T, false><<<grid, THREADS, 0, stream>>>(idx, val, p, c, n, kb, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int touch(F* kernel, int rc) {
  cudaFuncAttributes attr;
  const int err = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
  return rc != 0 ? rc : err;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success); none synchronises.
// idx: int32, val: f32, p and c: f32 or bf16, all contiguous on the card.
extern "C" int sparse_gossip_f32(const void* idx, const void* val, const void* p, void* c,
                                 int64_t n, int64_t k, int64_t d, void* stream) {
  return launch_gather(static_cast<const int32_t*>(idx), static_cast<const float*>(val),
                       static_cast<const float*>(p), static_cast<float*>(c), n, k, d,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int sparse_gossip_bf16(const void* idx, const void* val, const void* p, void* c,
                                  int64_t n, int64_t k, int64_t d, void* stream) {
  return launch_gather(static_cast<const int32_t*>(idx), static_cast<const float*>(val),
                       static_cast<const __nv_bfloat16*>(p), static_cast<__nv_bfloat16*>(c),
                       n, k, d, static_cast<cudaStream_t>(stream));
}

extern "C" int sparse_gossip_blocked_f32(const void* idx, const void* val, const void* p,
                                         void* c, int64_t n, int64_t kb, int64_t d,
                                         void* stream) {
  return launch_blocked(static_cast<const int32_t*>(idx), static_cast<const float*>(val),
                        static_cast<const float*>(p), static_cast<float*>(c), n, kb, d,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int sparse_gossip_blocked_bf16(const void* idx, const void* val, const void* p,
                                          void* c, int64_t n, int64_t kb, int64_t d,
                                          void* stream) {
  return launch_blocked(static_cast<const int32_t*>(idx), static_cast<const float*>(val),
                        static_cast<const __nv_bfloat16*>(p), static_cast<__nv_bfloat16*>(c),
                        n, kb, d, static_cast<cudaStream_t>(stream));
}

// Loads every kernel of this file into the current context without
// launching one, so that a CUDA graph capture never meets a module that is
// not loaded yet (CUDA loads modules lazily).
extern "C" int sparse_gossip_load() {
  int rc = 0;
  rc = touch(ell_gather_kernel<float, true>, rc);
  rc = touch(ell_gather_kernel<float, false>, rc);
  rc = touch(ell_gather_kernel<__nv_bfloat16, true>, rc);
  rc = touch(ell_gather_kernel<__nv_bfloat16, false>, rc);
  rc = touch(blocked_ell_kernel<float, true>, rc);
  rc = touch(blocked_ell_kernel<float, false>, rc);
  rc = touch(blocked_ell_kernel<__nv_bfloat16, true>, rc);
  rc = touch(blocked_ell_kernel<__nv_bfloat16, false>, rc);
  return rc;
}
