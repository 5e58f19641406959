// DecAvg gossip mixing C = W @ P on Hopper (sm_90a), f32 accumulation.
//
// Replaces repro/kernels/gossip_mix.py::gossip_mix_pallas (the Pallas TPU
// kernel). W is the (M, K) row-stochastic mixing matrix in f32 (M = K = N
// nodes, 100 in the paper); P is the (K, D) node-stacked flattened parameter
// leaf in f32 or bf16; C is (M, D) in P's dtype.
//
// What bounds it at the main path's shapes: the paper MLP's 8 leaves hold
// 567,434 parameters, so one gossip round at N=100 reads and writes
// 100 x 567,434 f32 values twice over (about 454 MB, 0.136 ms at 3.35 TB/s)
// and needs 2 x 100 x 100 x 567,434 = 11.35 GFLOP as a dense product
// (0.169 ms at the 67 TFLOP/s f32 peak of the CUDA cores). The largest leaf,
// (100, 401,408), is about 0.12 ms by the same count. Dense, the product is
// bound by operations, barely: about 25 FLOP per byte against the card's 20.
// So the design keeps every FMA in registers fed from shared memory and
// reads each P byte from device memory once:
//
// - Each block owns a BM x BD output tile. BM = 128 covers all N = 100 rows,
//   so one block reads its P columns once. The TPU kernel's sequential k grid
//   axis and its VMEM accumulator become the loop over K inside the block and
//   an 8 x 8 register tile per thread. Two shared-memory stages let the next
//   P tile travel from device memory while the current one is multiplied.
// - f32 FMAs on the CUDA cores, not TF32: TF32 keeps about 1e-3 relative
//   accuracy and the reference tolerance is 3e-5.
// - Zero W tiles are skipped: after a block stages its W tile in shared
//   memory, __syncthreads_or tells every thread whether any entry is
//   non-zero; if none is, the block neither loads the P tile nor multiplies.
//   This replaces the Pallas kernel's SMEM support mask, with no extra pass.
// - Ragged M, K and D edges are masked here. Nothing is padded: padding D to
//   512 and N to 128, as the TPU wrapper does, would copy the whole 227 MB
//   node-stacked P every round.
// - Offsets into P and C are int64.
//
// A faster design (3xTF32 or wgmma with TMA) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output rows per block
constexpr int BD = 128;        // output columns per block
constexpr int BK = 16;         // contraction depth per shared-memory stage
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr int AS_LD = BM + 4;  // padded row of the transposed W tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// Four consecutive values of P as f32 (caller guarantees alignment).
__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Four consecutive outputs (caller guarantees alignment).
__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

// Stage W[m0:m0+BM, k0:k0+BK] in registers, 8 values a thread; 0 outside W.
__device__ __forceinline__ void load_w(float (&wr)[8], const float* __restrict__ w,
                                       int64_t m0, int64_t k0, int64_t m, int64_t k,
                                       int tid) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = tid + i * THREADS;
    const int64_t gr = m0 + e / BK, gk = k0 + e % BK;
    wr[i] = (gr < m && gk < k) ? w[gr * k + gk] : 0.f;
  }
}

// Write staged W values into the transposed tile; return whether any is non-zero.
__device__ __forceinline__ int store_w(float (*as)[AS_LD], const float (&wr)[8], int tid) {
  int nz = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = tid + i * THREADS;
    as[e % BK][e / BK] = wr[i];
    nz |= (wr[i] != 0.f);
  }
  return nz;
}

// Stage P[k0:k0+BK, d0:d0+BD] in registers as f32, 8 values a thread.
template <typename T, bool VEC>
__device__ __forceinline__ void load_p(float (&pr)[8], const T* __restrict__ p,
                                       int64_t k0, int64_t d0, int64_t k, int64_t d,
                                       int tid) {
  if (VEC) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * THREADS;
      const int64_t gk = k0 + e / (BD / 4), gc = d0 + (e % (BD / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gk < k && gc < d) v = load4(p + gk * d + gc);
      pr[4 * i] = v.x; pr[4 * i + 1] = v.y; pr[4 * i + 2] = v.z; pr[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + i * THREADS;
      const int64_t gk = k0 + e / BD, gc = d0 + e % BD;
      pr[i] = (gk < k && gc < d) ? to_f32(p[gk * d + gc]) : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_p(float (*bs)[BD], const float (&pr)[8], int tid) {
  if (VEC) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * THREADS;
      *reinterpret_cast<float4*>(&bs[e / (BD / 4)][(e % (BD / 4)) * 4]) =
          make_float4(pr[4 * i], pr[4 * i + 1], pr[4 * i + 2], pr[4 * i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + i * THREADS;
      bs[e / BD][e % BD] = pr[i];
    }
  }
}

// acc += As[kk, rows] x Bs[kk, cols] for one depth kk.
__device__ __forceinline__ void fma_step(float (&acc)[8][8], const float (*as)[AS_LD],
                                         const float (*bs)[BD], int kk, int tx, int ty) {
  const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
  const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
  const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
  const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// VEC: D % 4 == 0 and P, C aligned, so rows of P and C move 4 values at a time.
//
// Two shared-memory stages: while a block multiplies stage t, the P tile of
// stage t+1 is in flight to registers (issued only once the block has voted
// that W tile t+1 is not all zero), and the W tile of stage t+2 likewise.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
gossip_mix_kernel(const float* __restrict__ w, const T* __restrict__ p,
                  T* __restrict__ c, int64_t m, int64_t k, int64_t d,
                  int64_t m_tiles, int skip) {
  __shared__ __align__(16) float As[2][BK][AS_LD];  // W tiles, transposed: As[s][kk][row]
  __shared__ __align__(16) float Bs[2][BK][BD];     // P tiles: Bs[s][kk][col]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group: cols tx*4.. and 64+tx*4..
  const int ty = tid >> 4;  // row group: rows ty*4.. and 64+ty*4..
  const int64_t m0 = (static_cast<int64_t>(blockIdx.x) % m_tiles) * BM;
  const int64_t d0 = (static_cast<int64_t>(blockIdx.x) / m_tiles) * BD;
  const int64_t k_tiles = (k + BK - 1) / BK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float wr[8], pr[8];
  // Prologue: stage 0 in shared memory, W of stage 1 in registers. One
  // barrier both publishes a W tile and votes on skipping it.
  load_w(wr, w, m0, 0, m, k, tid);
  int live = __syncthreads_or(store_w(As[0], wr, tid)) || !skip;
  if (live) {
    load_p<T, VEC>(pr, p, 0, d0, k, d, tid);
    store_p<VEC>(Bs[0], pr, tid);
  }
  if (k_tiles > 1) load_w(wr, w, m0, BK, m, k, tid);
  __syncthreads();

  int s = 0;
  for (int64_t t = 0; t < k_tiles; ++t) {
    const int64_t k0 = t * BK;
    const bool has_next = t + 1 < k_tiles;  // uniform across the block
    int next_live = 0;
    if (has_next) {
      // As[s^1] was last read before the previous iteration's final barrier.
      next_live = __syncthreads_or(store_w(As[s ^ 1], wr, tid)) || !skip;
      if (next_live) load_p<T, VEC>(pr, p, k0 + BK, d0, k, d, tid);
      if (t + 2 < k_tiles) load_w(wr, w, m0, k0 + 2 * BK, m, k, tid);
    }
    if (live) {  // uniform: all-zero W tiles are skipped
      if (k - k0 >= BK) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) fma_step(acc, As[s], Bs[s], kk, tx, ty);
      } else {
        for (int kk = 0; kk < k - k0; ++kk) fma_step(acc, As[s], Bs[s], kk, tx, ty);
      }
    }
    if (next_live) store_p<VEC>(Bs[s ^ 1], pr, tid);
    __syncthreads();
    s ^= 1;
    live = next_live;
  }

  // Write the 8 x 8 register tile, masking the ragged edges.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gr = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gr >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gc = d0 + h * 64 + tx * 4;
      T* dst = c + gr * d + gc;
      if (VEC && gc + 3 < d) {
        store4(dst, &acc[i][h * 4]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < d) store1(dst + j, acc[i][h * 4 + j]);
      }
    }
  }
}

template <typename T>
int launch(const float* w, const T* p, T* c, int64_t m, int64_t k, int64_t d,
           int skip, cudaStream_t stream) {
  if (m <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const int64_t m_tiles = (m + BM - 1) / BM;
  const int64_t blocks = m_tiles * ((d + BD - 1) / BD);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(p) % align == 0 &&
                   reinterpret_cast<uintptr_t>(c) % align == 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec)
    gossip_mix_kernel<T, true><<<grid, THREADS, 0, stream>>>(w, p, c, m, k, d, m_tiles, skip);
  else
    gossip_mix_kernel<T, false><<<grid, THREADS, 0, stream>>>(w, p, c, m, k, d, m_tiles, skip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success); none synchronises.
extern "C" int gossip_mix_f32(const void* w, const void* p, void* c, int64_t m,
                              int64_t k, int64_t d, int skip, void* stream) {
  return launch(static_cast<const float*>(w), static_cast<const float*>(p),
                static_cast<float*>(c), m, k, d, skip,
                static_cast<cudaStream_t>(stream));
}

extern "C" int gossip_mix_bf16(const void* w, const void* p, void* c, int64_t m,
                               int64_t k, int64_t d, int skip, void* stream) {
  return launch(static_cast<const float*>(w), static_cast<const __nv_bfloat16*>(p),
                static_cast<__nv_bfloat16*>(c), m, k, d, skip,
                static_cast<cudaStream_t>(stream));
}
