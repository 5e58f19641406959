// Sparse DecAvg gossip C = W @ P on Hopper (sm_90a), W stored as ELL, f32
// accumulation, output in P's dtype. One kernel template, two layouts:
//
// 1. sparse_gossip_blocked (replaces repro/kernels/sparse_gossip.py::
//    sparse_gossip_blocked_pallas): the 8-row-blocked ELL layout of
//    core/sparse.block_ell_from_csr. For destination block b (rows 8b..8b+7)
//    and each tile slot t, idx[b, t] names a source block and
//    val[8b:8b+8, 8t:8t+8] holds the (8, 8) weights coupling the two:
//        out[8b + r, :] = sum_t sum_o val[8b + r, 8t + o] * P[8 idx[b, t] + o, :]
// 2. sparse_gossip (replaces sparse_gossip_pallas): the scalar ELL row
//    gather of core/sparse.ell_from_csr:
//        out[i, :] = sum_k val[i, k] * P[idx[i, k], :]
//
// Both read a row as a list of slots (K of them, or 8 KB), each a source row
// and a weight; only where a slot's source row comes from differs.
//
// What bounds them on this card. At the large_n preset's size (N = 1024,
// the 784-64-10 MLP, 50,890 values a node over 4 leaves) a gossip round must
// read P and write C once, 417 MB: 0.125 ms at 3.35 TB/s. Its multiply-adds
// (2 per W entry per column, 9 to 13 entries a row) take about 0.014 ms at
// the 67 TFLOP/s f32 rate of the CUDA cores, so the round is bound by bytes.
// But a kernel that reads a source row once per destination row moves 9 x P
// (1.85 GB on the ws graph) from L2 to the SMs, about what the L2 delivers in
// the time, and one that reads it once per 8-row block still 2.8 x P with a
// few 16-byte loads in flight a thread: latency, not bandwidth, then limits.
//
// The design, and what measurement on an H100 chose:
// - A work item is a window of up to WROWS = 16 destination rows x a slab
//   of 256 columns. Blocks are persistent, 3 on each SM; block b takes
//   window b % gw and every cs-th slab from b / gw, so the blocks in flight
//   work on cs neighbouring slabs (a few MB of P that stay in L2) and each
//   block keeps its window, and the window's plan, from one item to the
//   next. A narrow leaf (one to a few slabs) takes windows of fewer rows,
//   so that its items still fill one wave of blocks.
// - The plan of a window: the distinct source rows with a non-zero weight,
//   numbered in ascending order through a bitmap in shared memory, and for
//   each destination row its (staged row, weight) entries, sorted by source
//   row. It is built from one pass over the window's slots. All-zero tiles,
//   all-zero columns and zero-weight slots never enter it, so their rows
//   are never read. On the ws graph a 16-row window stages 2.30 x its rows
//   a slab, against 9 x for a row gather and 2.80 x for 8-row blocks
//   (chip_smoke.py phase 8 prints the counts of each layout).
// - A ring of STAGES stages of STAGE_ROWS row segments in shared memory. One
//   producer warp streams the window's distinct rows through it, each
//   segment with one bulk asynchronous copy (cp.async.bulk, completing on
//   the stage's full mbarrier), lane r copying row r of a stage: with one
//   thread issuing every copy, the issue was the kernel's limit.
//   Consumer warps release a stage on its empty mbarrier. No registers hold
//   loads in flight, and the next item's rows load while this item's last
//   stages are consumed.
// - Each of the 4 consumer warps owns 4 destination rows and each lane 8
//   columns. A warp walks the stage's staged rows that its rows use, in
//   ascending order, reads each once (two 16-byte shared loads) and adds it
//   with fmaf into the register sums of every one of its rows that has it:
//   neighbouring rows share most sources. The sums are stored with 16-byte
//   stores (8 bytes for bf16). No atomics: each row sums in ascending
//   source-row order, fixed by the layout, so every launch gives the same
//   bits, and the order does not depend on how the rows are grouped into
//   stages or passes. For the scalar ELL layout of the builders (CSR order)
//   it is the slot order; the blocked layout numbers its tiles in order of
//   first use, so there it is a fixed reordering of the slots.
// - 5 warps a block and 3 blocks a SM leave 128 registers a thread; with 9
//   warps a block (8 consumers) the kernel spilled at 96.
// - A window whose lists overflow (a row with more than MAX_ENTRIES / rows
//   entries in one source range) is planned in passes over narrower ranges
//   of source rows, in ascending order, the sums carried in registers.
// - Bulk copies need 16-byte aligned addresses and sizes: taken when P and
//   C are 16-byte aligned and a row is a multiple of 16 bytes (D % 4 == 0 in
//   f32, D % 8 == 0 in bf16). Other leaves (D = 1, 10, 513, an unaligned
//   slice) take the kernel's other path into the same ring: the producer
//   warp copies the segments value by value, with 4-byte cp.async in f32
//   (tracked by the same full mbarriers) and ordinary loads in bf16, and
//   the sums are stored one value at a time.
// - Ragged N and D are masked here: sources at or past N are never staged,
//   rows past N or columns past D never written. The indices are trusted to
//   lie in [0, N): checking them would cost a device-to-host sync a round.
// - f32 FMAs on the CUDA cores, not TF32 tensor cores: the reference's
//   tolerance is 3e-5 and TF32 keeps about 1e-3.
// - What limits it now: reading and writing at once. chip_smoke.py phase 8
//   times the w1 leaf (1024 x 50176 f32) beside a plain copy of it (torch
//   clone, the same bytes read and written): the kernel takes about 1.2
//   times the copy's time.
//
// Offsets into P and C are int64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 8;                         // rows per block of the blocked layout
constexpr int WROWS = 16;                     // destination rows of a work item, at most
constexpr int SLAB = 256;                     // columns of a work item
constexpr int CWARPS = 4;                     // consumer warps
constexpr int ROWS_PER_WARP = WROWS / CWARPS; // 4
constexpr int THREADS = (CWARPS + 1) * 32;    // the consumers and one producer warp
constexpr int STAGE_ROWS = 16;                // row segments a ring stage
constexpr int STAGES = 3;                     // ring depth
constexpr int MAX_ENTRIES = 2048;             // (destination, source) pairs of a plan
constexpr int RANGE = 8192;                   // source rows a plan's bitmap spans
constexpr int WORDS = RANGE / 32;
constexpr int END = 0x7fffffff;               // the staged row of a list's end marker

static_assert(SLAB == 32 * 8, "a lane owns 8 columns of the slab");
static_assert(WROWS <= 32, "a lane of the producer warp sorts a row's list in build_plan");

// The shared memory of a block, after the ring.
struct Plan {
  int2 ent[MAX_ENTRIES];       // row r's (staged row, weight bits) at r * cap, sorted, then END
  int32_t src[MAX_ENTRIES];    // the staged source rows, ascending
  uint32_t bits[WORDS];        // source rows c0 .. c0 + RANGE with an entry
  int32_t wpre[WORDS];         // set bits before each word
  int32_t cnt[WROWS];          // each row's entries
  int32_t c0, c1;              // the planned source range
  int32_t win, m;              // the planned window, its staged rows
  unsigned long long full[STAGES], empty[STAGES];
};

template <typename T>
__host__ __device__ constexpr size_t ring_bytes() {
  return static_cast<size_t>(STAGES) * STAGE_ROWS * SLAB * sizeof(T);
}
template <typename T>
__host__ __device__ constexpr size_t smem_bytes() { return ring_bytes<T>() + sizeof(Plan); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive on bar and add `bytes` to the transaction count its phase waits for.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A 4-byte asynchronous copy from global to shared memory.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
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

// One bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// both 16-byte aligned, completing on bar's transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float4 lds4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* s) {
  const uint2 raw = *reinterpret_cast<const uint2*>(s);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The sums are stored with the streaming hint (evict first): this kernel
// never reads them back.
__device__ __forceinline__ void store1(float* dst, float v) { __stcs(dst, v); }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  __stcs(reinterpret_cast<unsigned short*>(dst), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  __stcs(reinterpret_cast<uint2*>(dst), raw);
}

// Slots sl .. sl + V - 1 of one destination row (V = 4 in the blocked
// layout: one 16-byte load of weights, within one tile; 1 in the scalar ELL
// layout): their weights (0 where ok is false) and the source row of the
// first (the others follow it). vrow is the row's weights, irow its indices
// (the blocked layout: its block's).
template <bool BLOCKED, int V>
__device__ __forceinline__ int slot_group(const int32_t* __restrict__ irow,
                                          const float* __restrict__ vrow, int64_t sl, bool ok,
                                          float (&w)[V]) {
#pragma unroll
  for (int u = 0; u < V; ++u) w[u] = 0.f;
  if (!ok) return 0;
  // The weight and index loads are issued before either is used.
  if constexpr (BLOCKED) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(vrow + sl));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    return __ldg(irow + sl / BR) * BR + static_cast<int>(sl % BR);
  } else {
    w[0] = __ldg(vrow + sl);
    return __ldg(irow + sl);
  }
}

// Plan the sources [c0, ...) of window `win` (rows row0 .. row0 + wrows):
// the widest range from c0 (up to RANGE rows) in which no row has more than
// cap - 1 entries, its distinct source rows, and each row's list of entries
// sorted by source row, at ent[r * cap], ended by END. Called by every
// thread of the block, with the ring drained.
template <bool BLOCKED>
__device__ __forceinline__ void build_plan(Plan& pl, const int32_t* __restrict__ idx,
                                           const float* __restrict__ val, int64_t n, int64_t k,
                                           int wrows, int win, int c0) {
  constexpr int V = BLOCKED ? 4 : 1;  // slots a lane reads at once
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t slots = BLOCKED ? k * BR : k;
  const int64_t row0 = static_cast<int64_t>(win) * wrows;
  const int cap = MAX_ENTRIES / wrows;
  int range = n - c0 < RANGE ? static_cast<int>(n - c0) : RANGE;
  // 1. Each row's live slots in [c0, c0 + range), in slot order, into its
  //    list as (source row, weight), and their sources into the bitmap;
  //    halve the range while a list overflows.
  for (;;) {
    for (int w = tid; w < WORDS; w += THREADS) pl.bits[w] = 0u;
    __syncthreads();
    const int c1 = c0 + range;
    if (warp < CWARPS) {
      int cnt[ROWS_PER_WARP] = {};
      for (int64_t s0 = 0; s0 < slots; s0 += 32 * V) {
        const int64_t sl = s0 + V * lane;
        int src[ROWS_PER_WARP];  // every row's slots, loads in flight together
        float w[ROWS_PER_WARP][V];
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
          const int r = warp * ROWS_PER_WARP + i;
          const int64_t row = row0 + r;
          const bool ok = r < wrows && row < n && sl < slots;
          src[i] = slot_group<BLOCKED, V>(idx + (BLOCKED ? row / BR : row) * k, val + row * slots,
                                          sl, ok, w[i]);
        }
        // Slot u of a group is live if it weighs something and its source,
        // src[i] + u, lies in [c0, c1).
        auto live_at = [&](int i, int u) {
          return w[i][u] != 0.f && src[i] + u >= c0 && src[i] + u < c1;
        };
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
          // Slot order across the warp: the lanes' live counts, scanned.
          int live = 0;
#pragma unroll
          for (int u = 0; u < V; ++u) live += live_at(i, u);
          int incl = live;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int x = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += x;
          }
          int at = cnt[i] + incl - live;
          const int r = warp * ROWS_PER_WARP + i;
#pragma unroll
          for (int u = 0; u < V; ++u) {
            if (!live_at(i, u)) continue;
            const int rel = src[i] + u - c0;
            atomicOr(&pl.bits[rel >> 5], 1u << (rel & 31));
            if (at < cap - 1) pl.ent[r * cap + at] = make_int2(src[i] + u, __float_as_int(w[i][u]));
            ++at;
          }
          cnt[i] += __shfl_sync(0xffffffffu, incl, 31);
        }
      }
      if (lane == 0)
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) pl.cnt[warp * ROWS_PER_WARP + i] = cnt[i];
    }
    __syncthreads();
    bool over = false;
    for (int r = 0; r < wrows; ++r) over |= pl.cnt[r] > cap - 1;
    // A range of one source row gives each row at most one entry (the
    // layouts name a source once a row); the guard above keeps writes in
    // bounds regardless.
    if (!over || range == 1) break;
    range = (range + 1) / 2;
    __syncthreads();  // every thread has read cnt before it is counted again
  }
  // 2. Number the marked sources: set bits before each bitmap word.
  const int words = (range + 31) / 32;
  if (warp == 0) {
    constexpr int PER = WORDS / 32;
    int sum = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int w = lane * PER + i;
      sum += w < words ? __popc(pl.bits[w]) : 0;
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    int run = incl - sum;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int w = lane * PER + i;
      pl.wpre[w] = run;
      run += w < words ? __popc(pl.bits[w]) : 0;
    }
    if (lane == 31) pl.m = incl;
  }
  __syncthreads();
  // 3. The staged rows, ascending; each row's list sorted by source row
  //    (stably, by a lane of the producer warp: a layout from the builders
  //    is sorted or nearly so, and insertion is then linear), its sources
  //    turned into staged rows, and ended.
  for (int w = tid; w < words; w += THREADS) {
    uint32_t b = pl.bits[w];
    int j = pl.wpre[w];
    while (b != 0u && j < MAX_ENTRIES) {
      pl.src[j++] = c0 + 32 * w + __ffs(b) - 1;
      b &= b - 1u;
    }
  }
  if (warp == CWARPS && lane < wrows) {
    int2* e = pl.ent + lane * cap;
    const int cnt = min(pl.cnt[lane], cap - 1);
    for (int a = 1; a < cnt; ++a) {
      const int2 x = e[a];
      int b = a - 1;
      while (b >= 0 && e[b].x > x.x) {
        e[b + 1] = e[b];
        --b;
      }
      e[b + 1] = x;
    }
    for (int a = 0; a < cnt; ++a) {
      const int rel = e[a].x - c0;
      e[a].x = pl.wpre[rel >> 5] + __popc(pl.bits[rel >> 5] & ((1u << (rel & 31)) - 1u));
    }
    e[cnt] = make_int2(END, 0);
  }
  if (tid == 0) {
    pl.win = win;
    pl.c0 = c0;
    pl.c1 = c0 + range;
  }
  __syncthreads();
}

// Window x slab work items; see the header. BULK: P's rows go to the ring
// by bulk copies and C is stored 4 values at a time (16-byte aligned rows).
template <bool BLOCKED, typename T, bool BULK>
__global__ void __launch_bounds__(THREADS, 3)
window_kernel(const int32_t* __restrict__ idx, const float* __restrict__ val,
              const T* __restrict__ p, T* __restrict__ out, int64_t n, int64_t k, int64_t d,
              int wrows, int nwin, int nslab, int gw, int cs) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  Plan& pl = *reinterpret_cast<Plan*>(smem + ring_bytes<T>());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t ring0 = smem_addr(ring);
  auto full = [&](int s) { return smem_addr(&pl.full[s]); };
  auto empty = [&](int s) { return smem_addr(&pl.empty[s]); };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), BULK ? 1 : 32);
      mbar_init(empty(s), CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    pl.win = -1;
  }
  __syncthreads();

  uint32_t q = 0;  // ring stages used so far, the same count in every warp
  for (int win = blockIdx.x % gw; win < nwin; win += gw) {
    const int64_t row0 = static_cast<int64_t>(win) * wrows;
    for (int sl = blockIdx.x / gw; sl < nslab; sl += cs) {
      const int64_t slab0 = static_cast<int64_t>(sl) * SLAB;
      const int cols = static_cast<int>(d - slab0 < SLAB ? d - slab0 : SLAB);
      int c0 = 0;
      if (pl.win != win || pl.c0 != c0) {
        __syncthreads();  // every warp is done with the plan in use
        build_plan<BLOCKED>(pl, idx, val, n, k, wrows, win, c0);
      }
      float acc[ROWS_PER_WARP][8];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (;;) {
        const int m = pl.m;
        const int nst = (m + STAGE_ROWS - 1) / STAGE_ROWS;
        if (warp == CWARPS) {
          // Producer: the plan's rows through the ring, stage by stage.
          for (int g = 0; g < nst; ++g, ++q) {
            const int s = q % STAGES;
            if (q >= STAGES) mbar_wait(empty(s), (q / STAGES - 1) & 1);
            const int nr = min(STAGE_ROWS, m - g * STAGE_ROWS);
            const int32_t* src = pl.src + g * STAGE_ROWS;
            if (BULK) {
              // Lane 0 sets the stage's bytes, then lane r copies row r: one
              // thread issuing them all would be the kernel's limit.
              const uint32_t bytes = static_cast<uint32_t>(cols * sizeof(T));
              if (lane == 0) mbar_expect(full(s), bytes * nr);
              __syncwarp();
              if (lane < nr)
                bulk_copy(ring0 + static_cast<uint32_t>(((s * STAGE_ROWS + lane) * SLAB) * sizeof(T)),
                          p + static_cast<int64_t>(src[lane]) * d + slab0, bytes, full(s));
            } else if (sizeof(T) == 4) {
              // f32: one 4-byte asynchronous copy a value; each lane's
              // arrival on full fires once its copies so far have landed.
              const uint32_t dst = ring0 + static_cast<uint32_t>(s * STAGE_ROWS * SLAB * sizeof(T));
              for (int r = 0; r < nr; ++r) {
                const T* from = p + static_cast<int64_t>(src[r]) * d + slab0;
                for (int c = lane; c < cols; c += 32)
                  cp_async4(dst + static_cast<uint32_t>((r * SLAB + c) * sizeof(T)), from + c);
              }
              cp_async_arrive(full(s));
            } else {
              // bf16 (2-byte values, too narrow for cp.async): ordinary loads,
              // 8 a lane in flight before their stores.
              T* dst = ring + s * STAGE_ROWS * SLAB;
              const int total = nr * cols;
              for (int e0 = 0; e0 < total; e0 += 8 * 32) {
                T v[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                  const int e = e0 + u * 32 + lane, r = e / cols;
                  if (e < total) v[u] = p[static_cast<int64_t>(src[r]) * d + slab0 + e - r * cols];
                }
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                  const int e = e0 + u * 32 + lane, r = e / cols;
                  if (e < total) dst[r * SLAB + e - r * cols] = v[u];
                }
              }
              mbar_arrive(full(s));
            }
            __syncwarp();
          }
        } else {
          // Consumers: each stage, this warp's rows' entries that fall in
          // it, by staged row: the lowest next entry of the warp's rows names
          // the staged row, which is read once for every row that has it
          // (neighbouring rows share most of their sources). Each row still
          // sums in ascending source order. nxt[i] is row i's next entry
          // (END when done).
          int cur[ROWS_PER_WARP];
          int2 nxt[ROWS_PER_WARP];
#pragma unroll
          for (int i = 0; i < ROWS_PER_WARP; ++i) {
            const int r = warp * ROWS_PER_WARP + i;  // a row past wrows has no list
            cur[i] = r * (MAX_ENTRIES / wrows);
            nxt[i] = r < wrows ? pl.ent[cur[i]] : make_int2(END, 0);
          }
          for (int g = 0; g < nst; ++g, ++q) {
            const int s = q % STAGES;
            mbar_wait(full(s), (q / STAGES) & 1);
            // Staged row j of this stage lies at ring + base + j * SLAB.
            const int base = (s - g) * STAGE_ROWS * SLAB + 4 * lane;
            const int jend = (g + 1) * STAGE_ROWS;
            for (;;) {
              int j = nxt[0].x;  // the same in every lane: the warp's rows
#pragma unroll
              for (int i = 1; i < ROWS_PER_WARP; ++i) j = min(j, nxt[i].x);
              if (j >= jend) break;
              const T* x = ring + (base + j * SLAB);
              const float4 a = lds4(x), b = lds4(x + 128);
#pragma unroll
              for (int i = 0; i < ROWS_PER_WARP; ++i) {
                if (nxt[i].x != j) continue;
                const float w = __int_as_float(nxt[i].y);
                nxt[i] = pl.ent[++cur[i]];
                acc[i][0] = fmaf(w, a.x, acc[i][0]);
                acc[i][1] = fmaf(w, a.y, acc[i][1]);
                acc[i][2] = fmaf(w, a.z, acc[i][2]);
                acc[i][3] = fmaf(w, a.w, acc[i][3]);
                acc[i][4] = fmaf(w, b.x, acc[i][4]);
                acc[i][5] = fmaf(w, b.y, acc[i][5]);
                acc[i][6] = fmaf(w, b.z, acc[i][6]);
                acc[i][7] = fmaf(w, b.w, acc[i][7]);
              }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty(s));
          }
        }
        c0 = pl.c1;
        if (c0 >= n) break;
        // A window planned in passes: the next range of sources.
        __syncthreads();
        build_plan<BLOCKED>(pl, idx, val, n, k, wrows, win, c0);
      }
      if (warp < CWARPS) {
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
          const int r = warp * ROWS_PER_WARP + i;
          if (r >= wrows || row0 + r >= n) continue;
          const int64_t row = row0 + r;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = h * 128 + 4 * lane;
            T* dst = out + row * d + slab0 + c;
            if (BULK) {
              if (c < cols) store4(dst, &acc[i][4 * h]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (c + e < cols) store1(dst + e, acc[i][4 * h + e]);
            }
          }
        }
      }
    }
  }
}

// Blocks a SM can hold of each kernel, and the SM count, per device; set
// by sparse_gossip_load() on the current device, before any launch there
// (and so before any capture): the shared-memory attribute it sets holds
// for the current device's copy of each kernel only.
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices] = {};
int g_occ[kMaxDevices][2][2][2] = {};  // [device][blocked][bf16][bulk]

int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -1;
  return dev;
}

template <bool BLOCKED, typename T, bool BULK>
int prepare(int rc, int dev) {
  auto* kernel = window_kernel<BLOCKED, T, BULK>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes<T>())));
  int blocks = 0;
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, THREADS, smem_bytes<T>()));
  if (err == 0 && blocks < 1) err = static_cast<int>(cudaErrorInvalidConfiguration);
  g_occ[dev][BLOCKED][sizeof(T) == 2][BULK] = blocks;
  return rc != 0 ? rc : err;
}

template <bool BLOCKED, typename T>
int launch(const int32_t* idx, const float* val, const T* p, T* c, int64_t n, int64_t k,
           int64_t d, cudaStream_t stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const int dev = current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) return static_cast<int>(cudaErrorInitializationError);  // load first
  const bool bulk = (d * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(c) % 16 == 0;
  const int64_t nslab = (d + SLAB - 1) / SLAB;
  if (n > 0x7fffffff - RANGE || nslab > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t target = static_cast<int64_t>(g_sms[dev]) * g_occ[dev][BLOCKED][sizeof(T) == 2][bulk];
  // Windows of as few rows as one wave of blocks needs (up to WROWS): a
  // narrow leaf takes narrow windows rather than leave SMs idle.
  int64_t want = (n * nslab + target - 1) / target;  // rows a window for one wave of blocks
  want = (want + ROWS_PER_WARP - 1) / ROWS_PER_WARP * ROWS_PER_WARP;
  const int wrows = static_cast<int>(want < ROWS_PER_WARP ? ROWS_PER_WARP : want > WROWS ? WROWS : want);
  const int64_t nwin = (n + wrows - 1) / wrows;
  const int64_t gw = nwin < target ? nwin : target;
  int64_t cs = target / gw;
  if (cs > nslab) cs = nslab;
  if (cs < 1) cs = 1;
  const dim3 grid(static_cast<unsigned>(gw * cs));
  const size_t shmem = smem_bytes<T>();
  if (bulk)
    window_kernel<BLOCKED, T, true><<<grid, THREADS, shmem, stream>>>(
        idx, val, p, c, n, k, d, wrows, static_cast<int>(nwin), static_cast<int>(nslab),
        static_cast<int>(gw), static_cast<int>(cs));
  else
    window_kernel<BLOCKED, T, false><<<grid, THREADS, shmem, stream>>>(
        idx, val, p, c, n, k, d, wrows, static_cast<int>(nwin), static_cast<int>(nslab),
        static_cast<int>(gw), static_cast<int>(cs));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success); none synchronises.
// idx: int32, val: f32, p and c: f32 or bf16, all contiguous on the card.
// k is K for the row gather and KB for the blocked layout.
extern "C" int sparse_gossip_f32(const void* idx, const void* val, const void* p, void* c,
                                 int64_t n, int64_t k, int64_t d, void* stream) {
  return launch<false>(static_cast<const int32_t*>(idx), static_cast<const float*>(val),
                       static_cast<const float*>(p), static_cast<float*>(c), n, k, d,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int sparse_gossip_bf16(const void* idx, const void* val, const void* p, void* c,
                                  int64_t n, int64_t k, int64_t d, void* stream) {
  return launch<false>(static_cast<const int32_t*>(idx), static_cast<const float*>(val),
                       static_cast<const __nv_bfloat16*>(p), static_cast<__nv_bfloat16*>(c),
                       n, k, d, static_cast<cudaStream_t>(stream));
}

extern "C" int sparse_gossip_blocked_f32(const void* idx, const void* val, const void* p,
                                         void* c, int64_t n, int64_t kb, int64_t d,
                                         void* stream) {
  return launch<true>(static_cast<const int32_t*>(idx), static_cast<const float*>(val),
                      static_cast<const float*>(p), static_cast<float*>(c), n, kb, d,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int sparse_gossip_blocked_bf16(const void* idx, const void* val, const void* p,
                                          void* c, int64_t n, int64_t kb, int64_t d,
                                          void* stream) {
  return launch<true>(static_cast<const int32_t*>(idx), static_cast<const float*>(val),
                      static_cast<const __nv_bfloat16*>(p), static_cast<__nv_bfloat16*>(c),
                      n, kb, d, static_cast<cudaStream_t>(stream));
}

// Loads every kernel of this file into the current device's context
// without launching one, allows each its dynamic shared memory and records
// how many blocks a SM holds, so that a launch on that device (and a CUDA
// graph capture of one) needs no other runtime call. Call it on each device
// before the first launch there.
extern "C" int sparse_gossip_load() {
  const int dev = current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = 0;
  int rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  rc = prepare<false, float, true>(rc, dev);
  rc = prepare<false, float, false>(rc, dev);
  rc = prepare<false, __nv_bfloat16, true>(rc, dev);
  rc = prepare<false, __nv_bfloat16, false>(rc, dev);
  rc = prepare<true, float, true>(rc, dev);
  rc = prepare<true, float, false>(rc, dev);
  rc = prepare<true, __nv_bfloat16, true>(rc, dev);
  rc = prepare<true, __nv_bfloat16, false>(rc, dev);
  if (rc == 0) g_sms[dev] = sms;  // the device counts as loaded only once all went well
  return rc;
}

// The dynamic shared memory of a kernel and the blocks a SM holds on the
// current device, as sparse_gossip_load() recorded them (blocked, bf16,
// bulk: 0 or 1 each).
extern "C" int sparse_gossip_occupancy(int blocked, int bf16, int bulk, int* smem, int* blocks) {
  const int dev = current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  *smem = static_cast<int>(bf16 ? smem_bytes<__nv_bfloat16>() : smem_bytes<float>());
  *blocks = g_occ[dev][blocked != 0][bf16 != 0][bulk != 0];
  return g_sms[dev] == 0 ? static_cast<int>(cudaErrorInitializationError) : 0;
}
