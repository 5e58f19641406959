// The ELL slot sum of the plain sparse backends (`sparse`, `sparse_sharded`)
// on Hopper (sm_90a), f32:
//     out[i, :] = sum over k = 0 .. K-1, in slot order, of val[i, k] * src[idx[i, k], :]
// each product rounded to f32, then added to the row's running sum.
//
// It replaces no TPU kernel: the reference sums these rows with `jnp`
// segment sums. It was added because the plain version (one index_select,
// one multiply and one add over all R rows for each of the K slots, in
// column chunks) costs K x 3 launches a chunk: on the large_n preset's BA
// graph (N = 4096, m = 2) the hub's row has K = 117 slots against a mean of
// 5, so a round of the 784-64-10 member (50,890 values a node) was about
// 87,500 launches and 350 ms on the card, gathering 97.6 GB for the 4.17 GB
// the real entries need.
//
// The results are the plain version's bit for bit: the products and sums
// are __fmul_rn and __fadd_rn (nvcc would contract a*b+c into an FMA, which
// rounds once and changes the bits), in slot order, starting from the first
// product (a sum starts at -0, which adds nothing: -0 + x is x for every x).
// Zero-weight slots are skipped: for finite values x*0 is +-0 and adding it
// leaves a sum equal under torch.equal. Inf or NaN in a source row read
// only by a zero-weight slot does not reach the output, where the plain
// version's product would make it NaN.
//
// What bounds it on this card. At that shape a round must read the source
// rows once and write the output once, 4096 x 50,890 f32 each: 1.67 GB,
// 0.498 ms at 3.35 TB/s. Its multiply-adds (2 per real slot per column,
// 20,472 slots) take 0.031 ms at the 67 TFLOP/s f32 rate, so it is bound by
// bytes. A kernel that reads a source row segment once per slot moves
// 4.17 GB from L2 to the SMs, 2.5 times what device memory must deliver.
//
// The design:
// - A work item is up to ROWS = 16 (row, slab) pairs: 16 rows of one slab
//   of SLAB = 256 columns, or, for fewer rows than 16, those rows over
//   several slabs. Items are numbered slab first, so the blocks in flight
//   (about 500) cover two or three slabs of every row: 4096 rows x 1 KB is
//   4 MB a slab, which stays in the 50 MB L2, and the gathered segments
//   come from L2 while device memory sees each source segment about once.
// - Each of a block's 8 warps takes the item's next pair from a counter in
//   shared memory until none is left, so a warp that drew the hub's 117
//   slots does not hold back the rows the others sum. (BA's hubs are its
//   oldest, lowest-numbered nodes, so they share items.)
// - A warp sums one row over one slab. It reads the row's slot list 64
//   slots at a time (coalesced loads of the weights and the indices), takes
//   the live slots from a ballot of the non-zero weights, in order, and
//   loads the source segments of two slots at a time before adding them in
//   order. Each lane owns 8 columns and adds its row's slots in order: no
//   atomics, no reduction across threads, so every launch gives the same
//   bits. 64 registers a thread: 4 blocks, 32 warps, a SM.
// - What limits it is the latency of the round trips a pair makes one
//   after another (its slot list, then its segments two slots at a time),
//   not device memory: with every slot reading the same source row, so
//   that every load hits, it takes about 0.8 of its time at the cell's
//   shape. Wider lanes, more slots at once, more or fewer rows an item and
//   4 warps a block were each measured no faster on the card (PERF.md).
// - The output is written once, with streaming stores, so it does not
//   push the source slabs out of L2.
// - Loads and stores of the widest vector (16, 8 or 4 bytes) that the
//   source's base, its row stride and the output all align to: 8 bytes for
//   the member's even D = 50,890, 16 for D % 4 == 0, 4 for an odd D or an
//   unaligned source. Each warp access is 32 contiguous vectors.
// - Any R, H (source rows), K and D; offsets are int64 (an LLM leaf's
//   R x D passes 2^31). The indices are trusted to lie in [0, H): checking
//   them would cost a device-to-host sync a round. idx is int32 or int64 as
//   the caller keeps it, so a round converts nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;               // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 8;                // columns a lane owns in a slab
constexpr int SLAB = 32 * COLS;        // columns of a (row, slab) pair
constexpr int ROWS = 16;               // (row, slab) pairs an item holds
constexpr int SLOTS = 2;               // live slots whose segments load at once
constexpr int CHUNKS = 2;              // 32-slot pieces of a slot list read at once
constexpr unsigned FULL = 0xffffffffu;

template <int W> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

// A lane's COLS columns of a row segment: COLS / W vectors of W values,
// vector v at column c0 + W (32 v + lane), so that each warp access is
// 32 W contiguous values. Columns at or past d are not read (their sums are
// never stored); d % W == 0, so a vector lies wholly before d or past it.
template <int W>
__device__ __forceinline__ int64_t column(int64_t c0, int v, int lane) {
  return c0 + W * (32 * v + lane);
}

template <int W>
__device__ __forceinline__ void load(const float* __restrict__ row, int64_t c0, int lane,
                                     int64_t d, float (&x)[COLS]) {
  using T = typename Vec<W>::T;
#pragma unroll
  for (int v = 0; v < COLS / W; ++v) {
    const int64_t c = column<W>(c0, v, lane);
    T t{};
    if (c < d) t = __ldg(reinterpret_cast<const T*>(row + c));
    const float* f = reinterpret_cast<const float*>(&t);
#pragma unroll
    for (int e = 0; e < W; ++e) x[W * v + e] = f[e];
  }
}

// Rounds each product, then the sum: no FMA contraction.
__device__ __forceinline__ void add(float (&acc)[COLS], float w, const float (&x)[COLS]) {
#pragma unroll
  for (int v = 0; v < COLS; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(w, x[v]));
}

// + 0 turns a sum of no live slot (-0) into +0 and leaves any other sum as
// it is. Streaming stores: the output is written once and read by no one
// here, so it should not push the source's slabs out of L2.
template <int W>
__device__ __forceinline__ void store(float* __restrict__ row, int64_t c0, int lane, int64_t d,
                                      const float (&acc)[COLS]) {
  using T = typename Vec<W>::T;
#pragma unroll
  for (int v = 0; v < COLS / W; ++v) {
    const int64_t c = column<W>(c0, v, lane);
    if (c < d) {
      T t;
      float* f = reinterpret_cast<float*>(&t);
#pragma unroll
      for (int e = 0; e < W; ++e) f[e] = __fadd_rn(acc[W * v + e], 0.f);
      __stcs(reinterpret_cast<T*>(row + c), t);
    }
  }
}

template <typename I, int W>
__global__ void __launch_bounds__(THREADS) ell_sum_kernel(
    const I* __restrict__ idx, const float* __restrict__ val, const float* __restrict__ src,
    float* __restrict__ out, int64_t r, int64_t k, int64_t d, int64_t ld, int64_t rows,
    int64_t slabs, int64_t groups, int64_t items) {
  __shared__ int next;
  const int lane = threadIdx.x & 31;
  const int64_t nslab = (d + SLAB - 1) / SLAB;
  const int pairs = static_cast<int>(rows * slabs);
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    __syncthreads();  // every warp is done with the last item's counter
    if (threadIdx.x == 0) next = 0;
    __syncthreads();
    const int64_t g = item % groups;   // the item's rows
    const int64_t s0 = item / groups;  // and slabs
    for (;;) {
      int p = 0;
      if (lane == 0) p = atomicAdd(&next, 1);
      p = __shfl_sync(FULL, p, 0);
      if (p >= pairs) break;
      const int64_t i = g * rows + p % rows;
      const int64_t slab = s0 * slabs + p / rows;
      if (i >= r || slab >= nslab) continue;
      const int64_t c0 = slab * SLAB;
      const I* ri = idx + i * k;
      const float* rv = val + i * k;
      float acc[COLS];
#pragma unroll
      for (int v = 0; v < COLS; ++v) acc[v] = -0.f;
      for (int64_t k0 = 0; k0 < k; k0 += 32 * CHUNKS) {
        float w[CHUNKS];
        long long j[CHUNKS];
#pragma unroll
        for (int q = 0; q < CHUNKS; ++q) {  // lane l holds slots k0 + 32 q + l
          const int64_t s = k0 + 32 * q + lane;
          w[q] = s < k ? rv[s] : 0.f;
          j[q] = s < k ? static_cast<long long>(ri[s]) : 0;
        }
#pragma unroll
        for (int q = 0; q < CHUNKS; ++q) {
          unsigned live = __ballot_sync(FULL, w[q] != 0.f);
          while (live) {  // the live slots in order, up to SLOTS at a time
            float ws[SLOTS];
            long long js[SLOTS];
            int n = 0;
#pragma unroll
            for (int u = 0; u < SLOTS; ++u) {
              const int a = live ? __ffs(live) - 1 : 0;
              if (live) {
                live &= live - 1;
                n = u + 1;
              }
              ws[u] = __shfl_sync(FULL, w[q], a);
              js[u] = __shfl_sync(FULL, j[q], a);
            }
            float x[SLOTS][COLS];
#pragma unroll
            for (int u = 0; u < SLOTS; ++u)
              if (u < n) load<W>(src + js[u] * ld, c0, lane, d, x[u]);
#pragma unroll
            for (int u = 0; u < SLOTS; ++u)
              if (u < n) add(acc, ws[u], x[u]);
          }
        }
      }
      store<W>(out + i * d, c0, lane, d, acc);
    }
  }
}

template <typename I, int W>
void run(const I* idx, const float* val, const float* src, float* out, int64_t r, int64_t k,
         int64_t d, int64_t ld, int64_t rows, int64_t slabs, int64_t groups, int64_t items,
         cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(items < 0x7fffffff ? items : 0x7fffffff));
  ell_sum_kernel<I, W><<<grid, THREADS, 0, stream>>>(idx, val, src, out, r, k, d, ld, rows,
                                                     slabs, groups, items);
}

// The widest vector every row segment's columns are aligned to.
int width(const float* src, const float* out, int64_t d, int64_t ld) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out);
  if (d % 4 == 0 && ld % 4 == 0 && a % 16 == 0) return 4;
  if (d % 2 == 0 && ld % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

template <typename I>
int launch(const I* idx, const float* val, const float* src, float* out, int64_t r, int64_t k,
           int64_t d, int64_t ld, cudaStream_t stream) {
  if (r <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if (k < 0 || ld < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nslab = (d + SLAB - 1) / SLAB;
  // An item's pairs: ROWS rows of one slab, or all r rows over as many
  // slabs as make ROWS pairs.
  const int64_t rows = r < ROWS ? r : ROWS;
  int64_t slabs = ROWS / rows;
  if (slabs > nslab) slabs = nslab;
  const int64_t groups = (r + rows - 1) / rows;
  const int64_t items = groups * ((nslab + slabs - 1) / slabs);
  switch (width(src, out, d, ld)) {
    case 4: run<I, 4>(idx, val, src, out, r, k, d, ld, rows, slabs, groups, items, stream); break;
    case 2: run<I, 2>(idx, val, src, out, r, k, d, ld, rows, slabs, groups, items, stream); break;
    default: run<I, 1>(idx, val, src, out, r, k, d, ld, rows, slabs, groups, items, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// Loads the kernels for index type I into the current device's context.
template <typename I>
int load_all() {
  cudaFuncAttributes attr;
  int rc = static_cast<int>(cudaFuncGetAttributes(&attr, ell_sum_kernel<I, 1>));
  if (rc == 0) rc = static_cast<int>(cudaFuncGetAttributes(&attr, ell_sum_kernel<I, 2>));
  if (rc == 0) rc = static_cast<int>(cudaFuncGetAttributes(&attr, ell_sum_kernel<I, 4>));
  return rc;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success); none synchronises.
// idx (r, k) int32 or int64 and val (r, k) f32, contiguous; src f32 rows of
// d values, `ld` values apart, the first at `src`; out (r, d) f32,
// contiguous. src and out must not overlap.
extern "C" int ell_sum_i32(const void* idx, const void* val, const void* src, void* out,
                           int64_t r, int64_t k, int64_t d, int64_t ld, void* stream) {
  return launch(static_cast<const int32_t*>(idx), static_cast<const float*>(val),
                static_cast<const float*>(src), static_cast<float*>(out), r, k, d, ld,
                static_cast<cudaStream_t>(stream));
}

extern "C" int ell_sum_i64(const void* idx, const void* val, const void* src, void* out,
                           int64_t r, int64_t k, int64_t d, int64_t ld, void* stream) {
  return launch(static_cast<const int64_t*>(idx), static_cast<const float*>(val),
                static_cast<const float*>(src), static_cast<float*>(out), r, k, d, ld,
                static_cast<cudaStream_t>(stream));
}

// Loads this file's kernels into the current device's context without
// launching one, so that a CUDA graph capture on that device can record a
// launch without loading a module. Call it on each device before the first
// capture there.
extern "C" int ell_sum_load() {
  const int rc = load_all<int32_t>();
  return rc != 0 ? rc : load_all<int64_t>();
}
