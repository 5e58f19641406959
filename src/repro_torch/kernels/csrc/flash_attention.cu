// Causal / sliding-window GQA flash attention on Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (the
// Pallas TPU kernel, body _kernel). It computes, for every batch row b and
// query head h (KV head h / group):
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, hk]) v[b, j, hk]
//
// over the keys j < T with j <= i (causal) and j > i - window (window), as
// an online softmax with an f32 running max, sum and accumulator, scale
// hd^-0.5. Query and key positions both start at 0, as in the TPU kernel
// (prefill calls it with S == T). q is (B, S, H, hd), k and v (B, T, Hkv, hd),
// each read through its strides (the last one must be 1): the layout
// attention_layer produces, with no transpose or copy. The output is a
// contiguous (B, S, H, hd) in q's dtype, f32 or bf16.
//
// What bounds it at the serving engine's shapes: one admission of
// llama3.2-1b prefills S = T <= 1024 tokens with 32 query heads, 8 KV heads
// and hd = 64, in bf16. At S = 1024 the inputs and output are 10.5 MB
// (3.1 us at 3.35 TB/s), and the causal half of QK^T and PV is 4.3 GFLOP
// (4.35 us at the 989 TFLOP/s bf16 tensor-core peak): operations bound it,
// and only the tensor cores come near that bound.
//
// Two kernels share the tiling: one block per (64-query tile, batch row x
// query head), a loop over 64-key tiles staged in shared memory, each row's
// max, sum and accumulator in registers across the loop (the TPU kernel's
// VMEM scratch and its sequential kv grid axis become this loop).
//
// - bf16 (the serving path): tensor cores, mma.sync m16n8k16 with f32
//   accumulation, 4 warps of 16 query rows. Q's fragments stay in registers
//   for the whole loop; K and V fragments come from shared memory by
//   ldmatrix (rows padded by 16 bytes so the 8 rows of one ldmatrix hit
//   distinct banks). The scores stay in registers: their accumulator layout
//   is the A-operand layout of the PV product, so P never goes through
//   shared memory. P is rounded to bf16 for that product, as a hi + lo pair
//   of bf16 values (two mma per tile, P = hi + lo to about 2^-17 relative),
//   so the result stays as close to an f32 computation as the f32 path is:
//   q, k and v are bf16 already, and their products are exact in f32.
// - f32: f32 FMAs on the CUDA cores (the f32 case must hold 3e-5, which
//   TF32 tensor cores do not), 256 threads as 16 x 16; a thread owns 4 query
//   rows, 4 key columns of the score tile and hd/16 output columns; a row's
//   64 scores sit in 16 lanes of one warp, reduced by shuffles; P goes
//   through shared memory for the PV product.
//
// Both:
// - Tiles wholly in the future, or wholly before the window, are skipped:
//   they contribute exact zeros. Causal prefill so does about half the work
//   of the square, where the TPU kernel visits and masks every tile. Query
//   tiles with the most key tiles start first.
// - Masked scores never reach exp: their probability is set to 0, and the
//   running max starts at the finite -1e30, so exp(-inf - -inf) cannot
//   occur. A row with no key (possible only with a window and S > T) gives 0.
// - Ragged S and T are masked here (q rows past S are not stored, keys past
//   T are zero and masked); nothing is padded on the host.
//
// Later work: a double-buffered K/V pipeline (cp.async or TMA) and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int RQ = 4;         // query rows per thread
constexpr int CK = 4;         // key columns per thread (tx + 16 j)
constexpr int PLD = BK + 4;   // row stride of the P tile
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int s, t, h, group, causal, window;
  float scale;
};

// ---------------------------------------------------------------------------
// f32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

// Stage rows [row0, row0 + 64) of one head (row r at src + r * stride) into
// dst with row stride ld, times scale; rows at or past nrows are zero.
template <int HD>
__device__ __forceinline__ void stage(float* dst, int ld, const float* __restrict__ src,
                                      int64_t stride, int row0, int nrows, float scale) {
  constexpr int V = HD / 4;
  for (int e = threadIdx.x; e < 64 * V; e += THREADS) {
    const int r = e / V, c = (e % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows) {
      x = *reinterpret_cast<const float4*>(src + static_cast<int64_t>(row0 + r) * stride + c);
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
}

// The key tiles [begin, end) that the query tile at q0 can see.
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int& begin, int& end) {
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.t, q0 + BQ) : p.t;
  begin = k_lo / BK;
  end = (k_hi + BK - 1) / BK;
}

// Whether query position qpos attends key position kpos.
__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.t && (!p.causal || kpos <= qpos) && (p.window <= 0 || kpos > qpos - p.window);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr int smem_floats() {
  // Q and K tiles (row stride HD + 4), the V tile, the P tile.
  return 2 * 64 * (HD + 4) + BK * HD + BQ * PLD;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_f32_kernel(const Params p) {
  constexpr int LD = HD + 4;
  constexpr int NJ = HD / 16;  // output columns per thread: tx + 16 j
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + 64 * LD;
  float* Vs = Ks + 64 * LD;
  float* Ps = Vs + BK * HD;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest key ranges first
  const int q0 = q_tile * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.h, h = bh % p.h, hk = h / p.group;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  int kt_begin, kt_end;
  key_tiles(p, q0, kt_begin, kt_end);

  stage<HD>(Qs, LD, q, p.q_ss, q0, p.s, p.scale);

  float m[RQ], l[RQ], acc[RQ][NJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    stage<HD>(Ks, LD, k, p.k_st, k0, p.t, 1.f);
    stage<HD>(Vs, HD, v, p.v_st, k0, p.t, 1.f);
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * RQ + i) * LD + d);
#pragma unroll
      for (int j = 0; j < CK; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // Online softmax, row by row; masked scores get probability 0.
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + ty * RQ + i;
      bool ok[CK];
      float rmax = NEG;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = visible(p, qpos, kpos);
        if (ok[j]) rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(rmax));
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float pr = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * RQ + i) * PLD + tx + 16 * j] = pr;
        rsum += pr;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += P V over this tile's 64 keys.
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * RQ + i) * PLD + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) vv[j] = Vs[(c + cc) * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float pi = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pi, vv[j], acc[i][j]);
        }
      }
    }
  }

  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty * RQ + i;
    if (qpos >= p.s) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* row = o + ((static_cast<int64_t>(b) * p.s + qpos) * p.h + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

template <int HD>
constexpr int mma_smem_bytes() {
  return 3 * 64 * (HD + 8) * 2;  // Q, K and V tiles, rows padded by 8 values
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as a bf16 pair hi, and what hi leaves over as a pair lo.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Stage rows [row0, row0 + 64) of one head into dst (row stride HD + 8),
// 4 values (8 bytes) a load; rows at or past nrows are zero.
template <int HD>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                           int64_t stride, int row0, int nrows) {
  constexpr int V = HD / 4;
  for (int e = threadIdx.x; e < 64 * V; e += MMA_THREADS) {
    const int r = e / V, c = (e % V) * 4;
    uint2 x = make_uint2(0u, 0u);
    if (row0 + r < nrows) {
      x = *reinterpret_cast<const uint2*>(src + static_cast<int64_t>(row0 + r) * stride + c);
    }
    *reinterpret_cast<uint2*>(dst + r * (HD + 8) + c) = x;
  }
}

// Fragment layouts are those of mma.m16n8k16: lane = 4 g + c holds, in an
// f32 accumulator tile, rows g and g + 8 and columns 2c and 2c + 1.
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_bf16_kernel(const Params p) {
  constexpr int LD = HD + 8;
  constexpr int KS = HD / 16;  // k-steps of QK^T over hd
  constexpr int NT = BK / 8;   // score n-tiles per key tile
  constexpr int OT = HD / 8;   // output n-tiles
  extern __shared__ float4 smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + 64 * LD;
  __nv_bfloat16* Vs = Ks + 64 * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest key ranges first
  const int q0 = q_tile * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.h, h = bh % p.h, hk = h / p.group;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  int kt_begin, kt_end;
  key_tiles(p, q0, kt_begin, kt_end);

  // This warp's 16 query rows as A fragments, kept for the whole loop.
  stage_bf16<HD>(Qs, q, p.q_ss, q0, p.s);
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], smem_addr(Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8));

  const int row = q0 + warp * 16 + g;  // this lane's rows: row and row + 8
  float o[OT][4], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < OT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and V are no longer read
    stage_bf16<HD>(Ks, k, p.k_st, k0, p.t);
    stage_bf16<HD>(Vs, v, p.v_st, k0, p.t);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys; K rows are the col-major B operand.
    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int pp = 0; pp < NT / 2; ++pp) {
        uint32_t kb[4];
        ldsm_x4(kb, smem_addr(Ks + (pp * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                              ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * pp], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * pp + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // Scale and mask, then the online softmax of rows row and row + 8.
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = visible(p, row + (e >> 1) * 8, k0 + 8 * t + c2 + (e & 1));
        s[t][e] = ok ? s[t][e] * p.scale : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
      }
    float m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      const float corr = expf(m[i] - m_new[i]);
      m[i] = m_new[i];
      l[i] *= corr;  // this lane's part of the row sum; the quad adds up at the end
#pragma unroll
      for (int t = 0; t < OT; ++t) {
        o[t][2 * i] *= corr;
        o[t][2 * i + 1] *= corr;
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = s[t][e] == NEG ? 0.f : expf(s[t][e] - m_new[e >> 1]);
        s[t][e] = pr;
        l[e >> 1] += pr;
      }

    // O += P V, 16 keys a k-step; V rows are the row-major B operand
    // (ldmatrix.trans), P comes straight from the score registers.
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * ks][0], s[2 * ks][1], ph[0], pl[0]);
      split_bf16(s[2 * ks][2], s[2 * ks][3], ph[1], pl[1]);
      split_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int u = 0; u < HD / 16; ++u) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, smem_addr(Vs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                    u * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * u], ph, vb[0], vb[1]);
        mma_bf16(o[2 * u], pl, vb[0], vb[1]);
        mma_bf16(o[2 * u + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * u + 1], pl, vb[2], vb[3]);
      }
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = row + 8 * i;
    if (r >= p.s) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* dst = out + ((static_cast<int64_t>(b) * p.s + r) * p.h + h) * HD + c2;
#pragma unroll
    for (int t = 0; t < OT; ++t)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * t) =
          __floats2bfloat162_rn(o[t][2 * i] * inv, o[t][2 * i + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int bytes, bool& attr_set, const Params& p,
                   int64_t batch, cudaStream_t stream) {
  if (!attr_set) {  // once per kernel and process
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((p.s + BQ - 1) / BQ, static_cast<unsigned>(batch * p.h));
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int dtype, const Params& p, int64_t batch, cudaStream_t stream) {
  static bool f32_attr = false, bf16_attr = false;
  if (dtype == 0) {
    return launch(flash_attention_f32_kernel<HD>, THREADS,
                  smem_floats<HD>() * static_cast<int>(sizeof(float)), f32_attr, p, batch, stream);
  }
  return launch(flash_attention_bf16_kernel<HD>, MMA_THREADS, mma_smem_bytes<HD>(), bf16_attr, p,
                batch, stream);
}

cudaError_t dispatch(int dtype, const Params& p, int64_t batch, int head_dim,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch_hd<32>(dtype, p, batch, stream);
    case 64: return launch_hd<64>(dtype, p, batch, stream);
    case 80: return launch_hd<80>(dtype, p, batch, stream);
    case 128: return launch_hd<128>(dtype, p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 for f32, 1 for bf16. Strides are in elements; the last dimension
// of q, k and v has stride 1. window <= 0 means no window. Returns the CUDA
// error of the launch (0 on success).
extern "C" int flash_attention_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v, void* out,
    int64_t batch, int64_t s, int64_t t, int64_t h, int64_t hkv,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh,
    int causal, int window, float scale, void* stream) {
  if (s <= 0 || batch <= 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = out;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.s = static_cast<int>(s);
  p.t = static_cast<int>(t);
  p.h = static_cast<int>(h);
  p.group = static_cast<int>(h / hkv);
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, p, batch, head_dim, st);
}
