// DecAvg gossip mixing C = W @ P on Hopper (sm_90a), f32 accuracy on the
// tensor cores.
//
// Replaces repro/kernels/gossip_mix.py::gossip_mix_pallas (the Pallas TPU
// kernel). W is the (M, K) row-stochastic mixing matrix in f32 (M = K = N
// nodes, 100 in the paper); P is the (K, D) node-stacked flattened parameter
// leaf in f32 or bf16; C is (M, D) in P's dtype.
//
// What bounds it at the main path's shapes: the paper MLP's 8 leaves hold
// 567,434 parameters, so one gossip round at N=100 reads and writes
// 100 x 567,434 f32 values (about 454 MB, 0.136 ms at 3.35 TB/s). As a dense
// product it is 2 x 100 x 100 x 567,434 = 11.35 GFLOP: 0.169 ms at the
// 67 TFLOP/s f32 peak of the CUDA cores, which bounded the earlier design
// (f32 FMAs) above the bytes. On the tensor cores TF32 alone keeps about
// 1e-3 relative accuracy against the reference's 3e-5, so the product is
// split (3xTF32): each f32 x = big + small, both rounded to TF32, and
// W P = Wb Pb + Wb Ps + Ws Pb with f32 accumulation; the dropped Ws Ps is
// about 2^-22 relative. That is 3 x 11.35 GFLOP, 0.069 ms at the 495 TFLOP/s
// TF32 peak, so the bytes bound it. A bf16 P is exact in TF32: only W is
// split, two products.
//
// The design reads each P byte from device memory once and writes each C
// byte once:
//
// - The product is computed transposed, C^T = P^T W^T, with wgmma m64nNk8
//   (TF32, f32 accumulation): a warpgroup owns 64 columns of P (wgmma's M),
//   N covers the block's rows of W (32, 64, 104 or 128: 104 at N=100, no
//   row of padding past 8), and K runs over the nodes 8 at a time. So W is
//   the B operand and is K-major as it lies, and P^T is the A operand,
//   loaded from shared memory into registers in wgmma's fragment layout
//   (no transpose in memory) and split into big and small there. W is split
//   once, when it is staged: big and small sit in shared memory as core
//   matrices without swizzle (W is held twice, since wgmma reads B only
//   from shared memory). P, the large operand, is held once, as it is in
//   device memory.
// - Persistent blocks, one per SM at most, each walking over work items
//   (up to 128 rows of C x 64 or 128 columns). At N <= 128 one item's rows
//   are all of C, and the whole split W (86 KB at N=100) stays in shared
//   memory for the block's life; each item streams one slab of P (K x 128).
//   A narrow leaf, whose items would leave most SMs idle, is cut into
//   32-row x 64-column items instead; its P (at most a few hundred KB) is
//   then read by up to four row tiles, from device memory once and from the
//   L2 cache after. At larger K, W is staged chunk by
//   chunk (128 nodes) with each slab, in 64-row items. The TPU kernel's
//   sequential k grid axis and its VMEM accumulator become this loop and the
//   wgmma accumulator.
// - P slabs pass through a ring of 2 shared-memory stages, filled by cp.async
//   (16 bytes a copy, zero-filled past K and D): slab i + 1 is in flight while
//   slab i is multiplied.
// - The k-steps of a slab are issued 4 at a time, as one group of wgmma with
//   one wait. Zero W tiles are skipped at that granularity (block_sparse,
//   which changes no result): when W is staged, each 8-node k-step gets a
//   bit saying whether any of the block's rows has a non-zero weight there,
//   and a group of 4 dead k-steps is neither split nor multiplied.
// - Ragged M, K and D edges are masked here. Nothing is padded: padding D to
//   512 and N to 128, as the TPU wrapper does, would copy the whole 227 MB
//   node-stacked P every round.
// - Offsets into P and C are int64.
//
// What limits it: at N=100 the large leaves stream at about two thirds of
// the bytes bound, with one slab in flight a SM (the split W leaves shared
// memory for two stages); the small leaves (D <= 1280) are latency: a
// launch, W staged and split, one slab. At N > 128 every slab re-stages and
// re-splits a W chunk, which makes the sparse N=300 ring of chip_smoke.py's
// phase 4 slower with tile skipping than the f32-FMA design this replaces.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KC = 128;       // nodes (K) of a W chunk and of a P slab
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

// Row stride of a P slab in shared memory, in elements: 16-byte rows for
// cp.async, and A-fragment loads on 32 distinct banks.
template <typename T, int NW>
__host__ __device__ constexpr int slab_ld() {
  return sizeof(T) == 4 ? NW * 64 + 8 : NW * 64 + 16;
}

// Shared memory of a block: W big and small (nb x kpad each), two P slabs
// (kpad x slab_ld), the live mask.
template <typename T, int NW>
__host__ __device__ constexpr int smem_bytes(int nb, int kpad) {
  return 2 * nb * kpad * 4 + 2 * kpad * slab_ld<T, NW>() * static_cast<int>(sizeof(T)) + 16;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 (round to nearest); x - big - small is about
// 2^-22 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// wgmma shared-memory descriptor without swizzle: the start address, LBO (the
// byte step between core matrices along K) and SBO (along N).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Pin accumulator registers in place around an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A use of fragment registers that an asynchronous wgmma reads: placed after
// its wait, it keeps the compiler from giving them to other values sooner.
__device__ __forceinline__ void hold(const uint32_t (&a)[4]) {
  asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]) : "memory");
}

// d += A (64 x 8, registers) B (8 x 32, shared memory, K-major), TF32.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (64 x 8, registers) B (8 x 64, shared memory, K-major), TF32.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (64 x 8, registers) B (8 x 104, shared memory, K-major), TF32.
__device__ __forceinline__ void wgmma_tf32_n104(float (&d)[52], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (64 x 8, registers) B (8 x 128, shared memory, K-major), TF32.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

template <int NB>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NB / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NB == 32) wgmma_tf32_n32(d, a, db);
  else if constexpr (NB == 64) wgmma_tf32_n64(d, a, db);
  else if constexpr (NB == 104) wgmma_tf32_n104(d, a, db);
  else wgmma_tf32_n128(d, a, db);
}

// One block: NW warpgroups, each 64 columns of an item; NB rows of C an item.
// wgmma's A fragment (P^T, 64 columns of P x 8 nodes): in warp w of the
// warpgroup, lane 4 g + q holds columns 16 w + g and 16 w + g + 8 at nodes q
// and q + 4. Its accumulator: acc[4 i + e] is column 16 w + g + 8 (e / 2) of
// P and row 8 i + 2 q + e % 2 of the item.
template <typename T, int NB, int NW>
__global__ void __launch_bounds__(NW * 128, 1)
gossip_mix_kernel(const float* __restrict__ w, const T* __restrict__ p, T* __restrict__ c,
                  int64_t m, int64_t k, int64_t d, int skip, int vec, int64_t d_slabs,
                  int k_chunks, int kpad) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int THREADS = NW * 128, BD = NW * 64, PLD = slab_ld<T, NW>();
  extern __shared__ float4 smem_raw[];
  float* wb = reinterpret_cast<float*>(smem_raw);  // W big [NB x kpad], core matrices
  float* wsm = wb + NB * kpad;                     // W small, the same layout
  T* ps = reinterpret_cast<T*>(wsm + NB * kpad);   // P slabs [2][kpad][PLD]
  uint32_t* live = reinterpret_cast<uint32_t*>(ps + 2 * kpad * PLD);  // bit j: k-step j

  const int tid = threadIdx.x, t = tid % 128, warp_id = tid >> 5;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int col = (tid / 128) * 64 + warp * 16 + g;  // this lane's first column in a slab
  const int64_t m_tiles = (m + NB - 1) / NB;
  const int64_t items = m_tiles * d_slabs;
  const int64_t mine = items > blockIdx.x ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t steps = mine * k_chunks;  // (item, k chunk), the chunks of an item in a row

  auto item_of = [&](int64_t st, int64_t& mt, int64_t& ds, int& kc) {
    const int64_t it = blockIdx.x + (st / k_chunks) * gridDim.x;
    kc = static_cast<int>(st % k_chunks);
    mt = it / d_slabs;
    ds = it % d_slabs;
  };
  // Nodes of chunk kc, rounded up to the 8 of a k-step.
  auto chunk_rows = [&](int kc) {
    const int64_t rem = k - static_cast<int64_t>(kc) * KC;
    return (static_cast<int>(rem < KC ? rem : KC) + 7) & ~7;
  };

  // P[k0 : k0 + rows, d0 : d0 + BD] into slab st % 2, zero past K and D.
  auto stage_p = [&](int64_t st) {
    int64_t mt, ds;
    int kc;
    item_of(st, mt, ds, kc);
    T* dst = ps + (st & 1) * kpad * PLD;
    const int64_t k0 = static_cast<int64_t>(kc) * KC, d0 = ds * BD;
    const int rows = chunk_rows(kc);
    if (vec) {
      constexpr int PER = 16 / sizeof(T), ROW = BD / PER;  // values a copy, copies a row
      for (int e = tid; e < rows * ROW; e += THREADS) {
        const int r = e / ROW, cc = (e % ROW) * PER;
        const int64_t gk = k0 + r, gc = d0 + cc;
        const bool ok = gk < k && gc < d;
        cp_async16(smem_addr(dst + r * PLD + cc), ok ? p + gk * d + gc : p, ok);
      }
    } else {
      for (int e = tid; e < rows * BD; e += THREADS) {
        const int r = e / BD, cc = e % BD;
        const int64_t gk = k0 + r, gc = d0 + cc;
        dst[r * PLD + cc] = (gk < k && gc < d) ? p[gk * d + gc] : from_f32<T>(0.f);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // W[m0 : m0 + NB, k0 : k0 + kpad], split into big and small (zero outside
  // W), and the mask of k-steps with a non-zero weight in these rows. The
  // caller makes sure that no warp still reads the staged W.
  auto stage_w = [&](int64_t mt, int kc) {
    const int64_t m0 = mt * NB, k0 = static_cast<int64_t>(kc) * KC;
    if (tid == 0) *live = skip ? 0u : 0xffffffffu;
    __syncthreads();
    // Warp by warp over rows, lanes along the row: coalesced loads, 4 rows
    // x 4 columns (16 loads) in flight a lane.
    uint32_t bits = 0;
    constexpr int WARPS = THREADS / 32;
    for (int r0 = warp_id; r0 < NB; r0 += 4 * WARPS) {
      float x[4][KC / 32];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < KC / 32; ++u) {
          const int r = r0 + i * WARPS, kk = lane + 32 * u;
          x[i][u] = (r < NB && kk < kpad && m0 + r < m && k0 + kk < k)
                        ? w[(m0 + r) * k + k0 + kk] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < KC / 32; ++u) {
          const int r = r0 + i * WARPS, kk = lane + 32 * u;
          if (r >= NB || kk >= kpad) continue;
          uint32_t big, small;
          split_tf32(x[i][u], big, small);
          const int off = (r >> 3) * (kpad * 8) + (kk >> 2) * 32 + (r & 7) * 4 + (kk & 3);
          wb[off] = __uint_as_float(big);
          wsm[off] = __uint_as_float(small);
          bits |= static_cast<uint32_t>(x[i][u] != 0.f) << (kk >> 3);
        }
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (skip && lane == 0 && bits) atomicOr(live, bits);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads W
    __syncthreads();
  };

  // G k-steps of 8 nodes from node 8 j0 on, as one group of wgmma: P^T's
  // fragments from the slab, split into big and small in registers, then
  // all the products into acc, then the wait. A group whose W columns are
  // all zero is skipped (a dead k-step inside a live group multiplies zeros).
  // Nothing is in flight between groups, so no branch sees acc in flight.
  const uint32_t wb_addr = smem_addr(wb), ws_addr = smem_addr(wsm);
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  auto k_steps = [&](auto size, const T* slab, int j0) {
    constexpr int G = decltype(size)::value;
    uint32_t ab[G][4], as[G][4];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const T* r0 = slab + (8 * (j0 + u) + q) * PLD + col;
      const T* r1 = r0 + 4 * PLD;
      const float x[4] = {to_f32(r0[0]), to_f32(r0[8]), to_f32(r1[0]), to_f32(r1[8])};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (F32) split_tf32(x[e], ab[u][e], as[u][e]);
        else ab[u][e] = __float_as_uint(x[e]);  // bf16 values are exact in TF32
      }
    }
    keep(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const uint64_t db = smem_desc(wb_addr + (j0 + u) * 256, 128, kpad * 32);
      const uint64_t dsm = smem_desc(ws_addr + (j0 + u) * 256, 128, kpad * 32);
      if constexpr (F32) wgmma_tf32<NB>(acc, as[u], db);
      wgmma_tf32<NB>(acc, ab[u], dsm);
      wgmma_tf32<NB>(acc, ab[u], db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    keep(acc);
#pragma unroll
    for (int u = 0; u < G; ++u) {
      hold(ab[u]);
      hold(as[u]);
    }
  };
  using G4 = std::integral_constant<int, 4>;
  using G3 = std::integral_constant<int, 3>;
  using G2 = std::integral_constant<int, 2>;
  using G1 = std::integral_constant<int, 1>;

  int64_t w_mt = -1;
  int w_kc = -1;
  if (steps > 0) stage_p(0);
  for (int64_t st = 0; st < steps; ++st) {
    int64_t mt, ds;
    int kc;
    item_of(st, mt, ds, kc);
    if (mt != w_mt || kc != w_kc) {  // once per block at N <= 128, while slab st travels
      __syncthreads();               // no warp still reads the staged W
      stage_w(mt, kc);
      w_mt = mt;
      w_kc = kc;
    }
    // Slab st has landed for every thread, and no warp still reads slab
    // st - 1, whose stage now takes slab st + 1.
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (st + 1 < steps) stage_p(st + 1);

    const T* slab = ps + (st & 1) * kpad * PLD;
    const int steps_here = chunk_rows(kc) / 8;
    const uint32_t bits = *live;  // block-uniform
    int j = 0;
    for (; j + 4 <= steps_here; j += 4)
      if ((bits >> j) & 0xfu) k_steps(G4{}, slab, j);
    if ((bits >> j) & ((1u << (steps_here - j)) - 1)) {
      switch (steps_here - j) {
        case 3: k_steps(G3{}, slab, j); break;
        case 2: k_steps(G2{}, slab, j); break;
        case 1: k_steps(G1{}, slab, j); break;
        default: break;
      }
    }

    if (kc == k_chunks - 1) {  // the item is complete: write and reset its tile
      const int64_t d0 = ds * BD, m0 = mt * NB;
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) {
        const int64_t gd = d0 + col + 8 * ((i >> 1) & 1);
        const int64_t gr = m0 + 8 * (i >> 2) + 2 * q + (i & 1);
        const float v = acc[i];
        acc[i] = 0.f;
        if (gr < m && gd < d) c[gr * d + gd] = from_f32<T>(v);
      }
    }
  }
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return count[dev];
}

template <typename T, int NB, int NW>
cudaError_t launch_kernel(const float* w, const T* p, T* c, int64_t m, int64_t k, int64_t d,
                          int skip, int vec, int kpad, cudaStream_t stream) {
  // The largest dynamic shared memory allowed so far, per device: the
  // attribute is set on the current device's copy of the kernel only.
  static int attr_bytes[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  const int bytes = smem_bytes<T, NW>(NB, kpad);
  if (bytes > attr_bytes[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        gossip_mix_kernel<T, NB, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_bytes[dev] = bytes;
  }
  const int64_t d_slabs = (d + NW * 64 - 1) / (NW * 64);
  const int64_t k_chunks = k > 0 ? (k + KC - 1) / KC : 1;
  const int64_t items = (m + NB - 1) / NB * d_slabs;
  const int64_t grid = items < sm_count() ? items : sm_count();
  if (k_chunks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  gossip_mix_kernel<T, NB, NW><<<static_cast<unsigned>(grid), NW * 128, bytes, stream>>>(
      w, p, c, m, k, d, skip, vec, d_slabs, static_cast<int>(k_chunks), kpad);
  return cudaGetLastError();
}

// Two warpgroups a block where their shared memory fits and the leaf is not
// narrow, else one.
template <typename T, int NB>
cudaError_t launch_nb(const float* w, const T* p, T* c, int64_t m, int64_t k, int64_t d,
                      int skip, int vec, int kpad, bool narrow, cudaStream_t stream) {
  if (!narrow && smem_bytes<T, 2>(NB, kpad) <= SMEM_MAX)
    return launch_kernel<T, NB, 2>(w, p, c, m, k, d, skip, vec, kpad, stream);
  return launch_kernel<T, NB, 1>(w, p, c, m, k, d, skip, vec, kpad, stream);
}

template <typename T>
int launch(const float* w, const T* p, T* c, int64_t m, int64_t k, int64_t d, int skip,
           cudaStream_t stream) {
  if (m <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const int vec = (d * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const int kpad = k >= KC ? KC : static_cast<int>((k + 7) / 8 * 8) + (k == 0 ? 8 : 0);
  // A narrow leaf, whose 128-column items would leave most SMs idle, is cut
  // finer (32-row tiles, 64 columns a block): more blocks, each with less W
  // to stage and less to multiply, where the time is latency.
  const bool narrow = 2 * ((m + 103) / 104) * ((d + 127) / 128) < sm_count();
  cudaError_t err;
  if (m <= 32 || narrow)
    err = launch_nb<T, 32>(w, p, c, m, k, d, skip, vec, kpad, narrow, stream);
  else if (m <= 64 || k > KC)  // past 128 nodes W is re-staged per slab: keep that share small
    err = launch_nb<T, 64>(w, p, c, m, k, d, skip, vec, kpad, false, stream);
  else if (m <= 104)
    err = launch_nb<T, 104>(w, p, c, m, k, d, skip, vec, kpad, false, stream);
  else
    err = launch_nb<T, 128>(w, p, c, m, k, d, skip, vec, kpad, false, stream);
  return static_cast<int>(err);
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
