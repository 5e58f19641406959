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
// each read through its strides (the last one must be 1, the others and the
// start a multiple of 16 bytes): the layout attention_layer produces, with no
// transpose or copy. The output is a contiguous (B, S, H, hd) in q's dtype,
// f32 or bf16.
//
// What bounds it at the serving engine's shapes: one admission of
// llama3.2-1b prefills S = T <= 1024 tokens with 32 query heads, 8 KV heads
// and hd = 64, in bf16. At S = 1024 the inputs and output are 10.5 MB
// (3.1 us at 3.35 TB/s), and the causal half of QK^T and PV is 4.3 GFLOP
// (4.35 us at the 989 TFLOP/s bf16 tensor-core peak): operations bound it,
// and only wgmma reaches the tensor cores' full rate on this card.
//
// bf16 (the serving path), one block per (64-query tile, batch row, KV head,
// up to NW query heads of that KV head's group), one warpgroup (128 threads)
// per query head:
// - K and V tiles of 64 keys pass through a ring of 5 shared-memory stages,
//   filled by cp.async (16 bytes a copy, zero-filled past T) and tracked by
//   mbarriers (full: every thread's copies into a stage have landed; empty:
//   every thread is done with its tile): tiles i + 1 and i + 2 are in flight
//   while tiles i and i - 1 are multiplied, and no block-wide barrier holds
//   the warpgroups in step. The block's query heads all read each staged
//   tile, so a K/V tile is loaded once for NW heads: NW = 2, or 1 where two
//   heads a block would leave more than half the SMs idle (short prompts).
//   Four heads a block (GQA group 4) measured slower: at 512 threads a block
//   the registers are capped at 128 a thread.
// - Within a warpgroup, S_i = Q K_i^T and O += P_{i-1} V_{i-1} are issued
//   together, and the softmax of tile i runs while the PV product of tile
//   i - 1 is in flight (P_i and P_{i-1} in two register sets). The two
//   warpgroups of a block take turns to issue their products (named
//   barriers), so that one's softmax can overlap the other's products.
// - Both products are wgmma m64nNk16 with f32 accumulation. S = Q K^T reads
//   Q and K from shared memory, both K-major (hd is contiguous). O += P V
//   takes P from registers (the scores' accumulator layout is wgmma's
//   A-fragment layout, so P never goes through shared memory) and V as the
//   MN-major B operand. Tiles sit in shared memory as core matrices without
//   swizzle (8 rows of 16 bytes, contiguous), one layout for every hd.
// - P is fed as a bf16 hi + lo pair, two wgmma on the same V (P = hi + lo to
//   about 2^-17 relative), so the result stays as close to an f32 computation
//   as the f32 path is: q, k and v are bf16 already, their products exact in f32.
// - Per score: one FMA (the scale folded with log2(e)) and one exp2. Only a
//   tile that crosses the diagonal, the window edge or T tests each score;
//   a masked score becomes -inf, whose exp2 is exactly 0.
// - What limits it: a pair of 64 x 64 tiles takes several times the tensor
//   cores' and the exp unit's time for its work, and variants of this file
//   without the exp, without QK^T, without the lo half of PV or without the
//   K/V loads, or with a deeper ring, ran barely faster. With 8 warps a SM
//   (2 warpgroups of 180 registers a thread) the chain of a tile (products,
//   wait, softmax, wait) is latency, not throughput. Double-buffered scores
//   (more registers) and 128-key tiles ran slower. The next design is
//   FlashAttention-3's: a producer warp with TMA and 128-byte swizzle, and
//   more warps a SM.
// f32: f32 FMAs on the CUDA cores (the f32 case must hold 3e-5, which TF32
// tensor cores do not), 256 threads as 16 x 16; a thread owns 4 query rows,
// 4 key columns of the score tile and hd/16 output columns; a row's 64 scores
// sit in 16 lanes of one warp, reduced by shuffles; P goes through shared
// memory for the PV product.
//
// Both:
// - Tiles wholly in the future, or wholly before the window, are skipped:
//   they contribute exact zeros. Causal prefill so does about half the work
//   of the square, where the TPU kernel visits and masks every tile. Query
//   tiles with the most key tiles start first.
// - The running max starts at the finite -1e30, and a masked score gets
//   probability 0, so exp(-inf - -inf) cannot occur. A row with no key
//   (possible only with a window and S > T) gives 0.
// - Ragged S and T are masked here (q rows past S are not stored, keys past
//   T are zero and masked); nothing is padded on the host.

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
// bf16: wgmma on the tensor cores, K and V through a cp.async ring
// ---------------------------------------------------------------------------

constexpr int WG = 128;      // threads of a warpgroup: one query head of the block
// Depth of the K/V ring: tiles i - 1 and i in use, tiles i + 1 and i + 2 in
// flight (AHEAD), one slot of slack between the warpgroups of a block.
constexpr int STAGES = 5, AHEAD = 2;
constexpr float LOG2E = 1.4426950408889634f;

// A 64-row tile of hd bf16 values, as core matrices without swizzle: element
// (r, c) at byte (r / 8) * RS + (c / 8) * 128 + (r % 8) * 16 + (c % 8) * 2,
// RS = hd * 16. Along hd the 16-byte chunks of a row are 128 bytes apart.
template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  return 64 * HD * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from global to shared memory, asynchronously; zeros if !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage rows [row0, row0 + 64) of one head (row r at src + r * stride) into
// the tile at dst, by `nthreads` threads numbered from `tid`; rows at or past
// nrows are zero. Eight neighbouring threads fill one 128-byte core matrix.
template <int HD>
__device__ __forceinline__ void stage_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                           int64_t stride, int row0, int nrows, int tid,
                                           int nthreads) {
  constexpr int CH = HD / 8;
  for (int e = tid; e < 64 * CH; e += nthreads) {
    const int c = (e >> 3) % CH, r = (e >> 3) / CH * 8 + (e & 7);
    const bool ok = row0 + r < nrows;
    const __nv_bfloat16* from = ok ? src + static_cast<int64_t>(row0 + r) * stride + c * 8 : src;
    cp_async16(dst + (r >> 3) * (HD * 16) + c * 128 + (r & 7) * 16, from, ok);
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive on bar once every cp.async this thread has issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// wgmma shared-memory descriptor without swizzle: the start address, LBO (the
// byte step between core matrices along K) and SBO (along M or N).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin accumulator registers in place around an asynchronous wgmma, so that
// no read or write of them moves across its issue or its wait.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A use of A-fragment registers that an asynchronous wgmma reads: placed
// after its wait, it keeps the compiler from giving them to other values sooner.
__device__ __forceinline__ void hold(const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm volatile("" ::"r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]) : "memory");
}

// d (+)= A (64 x 16, shared memory) B (16 x 64, shared memory, K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A (64 x 16, registers) B (16 x 32, shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (64 x 16, registers) B (16 x 64, shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (64 x 16, registers) B (16 x 80, shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (64 x 16, registers) B (16 x 128, shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (HD == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (HD == 80) wgmma_rs_n80(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values as a bf16 pair hi, and what hi leaves over as a pair lo.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Accumulator layout of wgmma m64nN (f32): in warp w of the warpgroup, lane
// 4 g + c holds d[4 j + e] at row 16 w + g + 8 (e / 2), column 8 j + 2 c + e % 2.
//
// Per warpgroup, key tile i overlaps with tile i - 1: S_i = Q K_i^T and
// O += P_{i-1} V_{i-1} are issued together, the softmax of S_i runs while
// the PV product is in flight, and O is rescaled once it has landed. P_i and
// P_{i-1} live in two register sets.
template <int HD, int NW>
__global__ void __launch_bounds__(NW * WG, 1)
flash_attention_bf16_kernel(const Params p, int q_tiles, int chunks) {
  constexpr int TILE = tile_bytes<HD>();
  constexpr int RS = HD * 16;  // bytes between the 8-row groups of a tile
  extern __shared__ float4 smem_raw[];
  const uint32_t q_smem = smem_addr(smem_raw) + (threadIdx.x / WG) * TILE;
  const uint32_t ring = smem_addr(smem_raw) + NW * TILE;

  const int tid = threadIdx.x, t = tid % WG;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, c2 = (lane & 3) * 2;
  // Block -> (query tile, batch row, KV head, head chunk); query tiles with
  // the most key tiles first.
  const int per_tile = gridDim.x / q_tiles;
  const int q_tile = q_tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int chunk = rest % chunks;
  rest /= chunks;
  const int hkv = p.h / p.group;
  const int hk = rest % hkv, b = rest / hkv;
  const int qh = chunk * NW + tid / WG;  // this warpgroup's head within the group
  const bool active = qh < p.group;     // uniform across the warpgroup
  const int h = hk * p.group + (active ? qh : 0);
  const int q0 = q_tile * BQ;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  int kt_begin, kt_end;
  key_tiles(p, q0, kt_begin, kt_end);
  const int n = kt_end - kt_begin;

  // The ring's barriers: full[s] completes when every thread's copies into
  // slot s have landed, empty[s] when every thread is done with the tile in
  // it. No block-wide barrier per tile: a warpgroup may run up to one tile
  // ahead of the other.
  const uint32_t bars = ring + STAGES * 2 * TILE;
  auto full = [&](int i) { return bars + 8 * (i % STAGES); };
  auto empty = [&](int i) { return bars + 8 * (STAGES + i % STAGES); };
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full(i), NW * WG);
      mbar_init(empty(i), NW * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // K/V tile i into slot i % STAGES, once the tile before it there is
  // released; this thread's share, then its arrival on full (when all its
  // copies so far, Q's included, have landed).
  auto load = [&](int i) {
    if (i >= n) return;
    if (i >= STAGES) mbar_wait(empty(i), (i / STAGES - 1) & 1);
    const uint32_t dst = ring + (i % STAGES) * 2 * TILE;
    const int row0 = (kt_begin + i) * BK;
    stage_tile<HD>(dst, k, p.k_st, row0, p.t, tid, NW * WG);
    stage_tile<HD>(dst + TILE, v, p.v_st, row0, p.t, tid, NW * WG);
    cp_async_arrive(full(i));
  };
  // Tile i has landed: its shared memory is visible to wgmma.
  auto acquire = [&](int i) {
    mbar_wait(full(i), (i / STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  if (active) stage_tile<HD>(q_smem, q, p.q_ss, q0, p.s, t, WG);
  for (int i = 0; i < AHEAD; ++i) load(i);

  const float c = p.scale * LOG2E;
  const int row = q0 + warp * 16 + g;  // this lane's rows: row and row + 8
  float o[HD / 2], s[32], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  uint32_t ph0[4][4], pl0[4][4], ph1[4][4], pl1[4][4];

  // S = Q K_i^T: 64 rows x 64 keys, hd / 16 k-steps of 32 bytes (issued).
  auto issue_qk = [&](int i) {
    const uint32_t ks = ring + (i % STAGES) * 2 * TILE;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, smem_desc(q_smem + kk * 256, 128, RS), smem_desc(ks + kk * 256, 128, RS),
                   kk);
    wgmma_commit();
  };
  // O += P_i V_i, 16 keys a k-step, P as a hi + lo pair (issued). V is the
  // MN-major B operand: K (keys) in 8-row groups RS apart, N (hd) in 16-byte
  // chunks 128 bytes apart.
  auto issue_pv = [&](int i, const uint32_t (&ph)[4][4], const uint32_t (&pl)[4][4]) {
    const uint32_t vs = ring + (i % STAGES) * 2 * TILE + TILE;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t db = smem_desc(vs + ks * 2 * RS, RS, 128);
      wgmma_pv<HD>(o, ph[ks], db);
      wgmma_pv<HD>(o, pl[ks], db);
    }
    wgmma_commit();
  };
  // The online softmax of tile i's scores (rows row and row + 8, in units of
  // log2): the new running max, corr = exp2(m_old - m_new), l, and P_i as A
  // fragments of n-tiles 2 ks and 2 ks + 1 in (ph, pl). Only a tile that
  // crosses the diagonal, the window edge or T is masked.
  auto softmax = [&](int i, uint32_t (&ph)[4][4], uint32_t (&pl)[4][4]) {
    const int k0 = (kt_begin + i) * BK;
    const bool interior = k0 + BK <= p.t && (!p.causal || k0 + BK - 1 <= q0) &&
                          (p.window <= 0 || k0 > q0 + BQ - 1 - p.window);
    if (!interior) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (!visible(p, row + ((e >> 1) & 1) * 8, k0 + 8 * (e >> 2) + c2 + (e & 1)))
          s[e] = __int_as_float(0xff800000);  // -inf
    }
    float mx[2] = {m[0], m[1]}, mc[2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2((m[r] - mx[r]) * c);
      m[r] = mx[r];
      mc[r] = mx[r] * c;
      l[r] *= corr[r];  // this lane's part of the row sum; the quad adds up at the end
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = ex2(fmaf(s[e], c, -mc[(e >> 1) & 1]));
      l[(e >> 1) & 1] += s[e];
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1], ph[ks][r], pl[ks][r]);
  };
  // With two warpgroups on one KV head, they take turns to issue their
  // products (named barriers 1 and 2), so that one's softmax runs while the
  // other's products do: warpgroup 0 issues first, then 1, then 0 ...
  const int wg = tid / WG;
  const bool turns = NW == 2 && chunk * NW + 1 < p.group;  // both warpgroups active
  auto turn_begin = [&](bool first) {
    if (turns && !(wg == 0 && first))
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(2 * WG) : "memory");
  };
  auto turn_end = [&]() {
    if (turns) asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "r"(2 * WG) : "memory");
  };
  // Iteration i >= 1: QK^T of tile i and PV of tile i - 1 in flight
  // together, then the softmax of tile i, then O rescaled.
  auto step = [&](int i, const uint32_t (&ph_prev)[4][4], const uint32_t (&pl_prev)[4][4],
                  uint32_t (&ph)[4][4], uint32_t (&pl)[4][4]) {
    keep(s);
    keep(o);
    turn_begin(false);
    wgmma_fence();
    issue_qk(i);
    issue_pv(i - 1, ph_prev, pl_prev);
    turn_end();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    keep(s);
    softmax(i, ph, pl);
    wgmma_wait();
    keep(o);
    hold(ph_prev);
    hold(pl_prev);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
  };

  if (n > 0) {
    load(AHEAD);
    acquire(0);
    if (active) {
      keep(s);
      turn_begin(true);
      wgmma_fence();
      issue_qk(0);
      turn_end();
      wgmma_wait();
      keep(s);
      softmax(0, ph0, pl0);  // O is still 0: nothing to rescale
    }
  }
  for (int i = 1; i < n; ++i) {
    load(i + AHEAD);
    acquire(i);
    if (active) {
      if (i & 1) step(i, ph0, pl0, ph1, pl1);
      else step(i, ph1, pl1, ph0, pl0);
    }
    mbar_arrive(empty(i - 1));  // QK^T and PV of tile i - 1 have finished
  }
  cp_async_wait_all();  // Q's copies, where no key tile waited for them
  if (!active) return;
  if (n > 0) {
    keep(o);
    turn_begin(false);
    wgmma_fence();
    if ((n - 1) & 1) issue_pv(n - 1, ph1, pl1);
    else issue_pv(n - 1, ph0, pl0);
    turn_end();
    if (turns && wg == 0)  // warpgroup 1's last turn_end
      asm volatile("bar.sync 1, %0;\n" ::"r"(2 * WG) : "memory");
    wgmma_wait();
    keep(o);
    hold(ph0);
    hold(pl0);
    hold(ph1);
    hold(pl1);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = row + 8 * r;
    if (qpos >= p.s) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst = out + ((static_cast<int64_t>(b) * p.s + qpos) * p.h + h) * HD + c2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return count[dev];
}

// The f32 kernel: grid (query tiles, B * H).
template <int HD>
cudaError_t launch_f32(const Params& p, int64_t batch, cudaStream_t stream) {
  // Once per kernel and device: the attribute is set on the current
  // device's copy of the kernel only.
  static bool attr_set[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  if (!attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  const dim3 grid((p.s + BQ - 1) / BQ, static_cast<unsigned>(batch * p.h));
  flash_attention_f32_kernel<HD><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The bf16 kernel with NW query heads a block: a 1-D grid of
// (query tiles) x B x Hkv x (head chunks of the group).
template <int HD, int NW>
cudaError_t launch_bf16(const Params& p, int64_t batch, cudaStream_t stream) {
  static bool attr_set[64] = {};  // once per kernel and device, as above
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  constexpr int bytes = (NW + 2 * STAGES) * tile_bytes<HD>() + 2 * STAGES * 8;
  if (!attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<HD, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  const int q_tiles = (p.s + BQ - 1) / BQ;
  const int chunks = (p.group + NW - 1) / NW;
  const int64_t blocks = static_cast<int64_t>(q_tiles) * batch * (p.h / p.group) * chunks;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_attention_bf16_kernel<HD, NW>
      <<<static_cast<unsigned>(blocks), NW * WG, bytes, stream>>>(p, q_tiles, chunks);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int dtype, const Params& p, int64_t batch, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<HD>(p, batch, stream);
  // Two query heads of a group share a block's K/V tiles, unless that
  // leaves fewer blocks than half the SMs (short prompts): then one.
  const int64_t pairs = static_cast<int64_t>((p.s + BQ - 1) / BQ) * batch * (p.h / p.group) *
                        ((p.group + 1) / 2);
  if (p.group >= 2 && 2 * pairs >= sm_count()) return launch_bf16<HD, 2>(p, batch, stream);
  return launch_bf16<HD, 1>(p, batch, stream);
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
