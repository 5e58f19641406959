// The selective scan of a Mamba-1 mixer on Hopper (sm_90a), f32, forward and
// backward. For each batch row b, channel d and state n, over time t:
//     dt[t]    = softplus(dt_in[t, d] + dt_bias[d])
//     h[t, n]  = exp(dt[t] * A[d, n]) * h[t-1, n] + (dt[t] * B[t, n]) * u[t, d]
//     y[t, d]  = sum over n of C[t, n] * h[t, n]  +  D[d] * u[t, d]
// from h[-1] = h0 (or zero). It returns y and h[S-1].
//
// It replaces no TPU kernel: the reference runs this recurrence as a
// chunked `lax.associative_scan` over (B, S, d_inner, d_state) tensors, and
// so does the plain version (`models/mamba.py`). Trained at a real length
// that does not fit: at d_inner 5120, d_state 16 and S 4096 each such f32
// tensor is 1.34 GB, and the log-depth scan and autograd keep about 20 GB a
// layer. This kernel never holds one: the state lives in registers.
//
// What bounds it. The forward reads u, dt_in (B, S, d_inner) and B, C
// (B, S, d_state) once and writes y once: at (1, 4096, 5120, 16) that is
// 252 MB, 75 us at 3.35 TB/s; its 2 exp-and-multiply-adds a (t, d, n) are
// 0.34 G operations, 5 us at the f32 rate. So bytes bound it, as long as
// the recurrence's chain of dependent steps (4096 of them) hides behind
// enough independent channels: one thread a (d, n) pair gives 81,920
// threads, 20 warps a SM.
//
// The design:
// - A block is 16 channels x 16 state lanes (256 threads); a channel's
//   states are 16 consecutive lanes of one warp. d_state up to 16: lanes
//   past it hold zeros. blockIdx.y is the batch row.
// - Time goes in chunks of T = 32 steps. The block stages a chunk's dt (the
//   softplus taken once per (t, d)), u, B and C in shared memory with
//   coalesced loads, then each thread runs the chunk's recurrence in f32
//   registers. y's sum over the states is a 16-lane shuffle reduction in a
//   fixed order; a chunk's y goes out through shared memory, coalesced.
// - With `states` given, the forward writes h at the start of each chunk,
//   (B, S/T, d_inner, d_state): 1/32 of what the plain version holds.
// - The backward walks the chunks last to first. For each it recomputes the
//   chunk's h from its saved start in registers (unrolled, 32 values a
//   thread), then runs the reverse recurrence g[t] = C[t] dy[t] + a[t+1]
//   g[t+1], taking every gradient of the step. The sums over the states (of
//   du and d dt) are shuffle reductions; the sums over channels (of dB and
//   dC) go through shared memory per warp and are written per block, and the
//   caller adds the blocks' parts (`torch.sum`, a fixed order). dA, dD and
//   d dt_bias sum over time in each thread, in order, and are written per
//   batch row for the caller to add. No atomics: every launch and every
//   replay gives the same bits.
// - expf, log1pf and the softplus threshold of 20 are PyTorch's; products
//   are taken in the plain version's order ((dt B) u), so the kernel stays
//   within float rounding of it, though not bit for bit (the plain version's
//   log-depth scan associates differently).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int T = 32;        // time steps a chunk
constexpr int CH = 16;       // channels a block
constexpr int NS = 16;       // state lanes a channel (d_state <= NS)
constexpr int THREADS = CH * NS;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

// d softplus(x) / dx as PyTorch's softplus backward takes it.
__device__ __forceinline__ float softplus_grad(float x) {
  if (x > 20.f) return 1.f;
  const float z = expf(x);
  return z / (z + 1.f);
}

// Sum over the 16 lanes of a channel, in a fixed order.
__device__ __forceinline__ float lane_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 8, NS);
  v += __shfl_xor_sync(FULL, v, 4, NS);
  v += __shfl_xor_sync(FULL, v, 2, NS);
  v += __shfl_xor_sync(FULL, v, 1, NS);
  return v;
}

__global__ void __launch_bounds__(THREADS) scan_fwd(
    const float* __restrict__ u, const float* __restrict__ dt_in,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ Dsk, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_last, float* __restrict__ states,
    int S, int D, int N, int NC) {
  __shared__ float s_dt[T][CH], s_u[T][CH], s_B[T][NS], s_C[T][NS], s_y[T][CH];
  const int tid = threadIdx.x, cl = tid / NS, n = tid % NS;
  const int d0 = blockIdx.x * CH, d = d0 + cl, b = blockIdx.y;
  const bool live = d < D && n < N;
  const float an = live ? A[static_cast<int64_t>(d) * N + n] : 0.f;
  const float dd = d < D ? Dsk[d] : 0.f;
  float h = (live && h0 != nullptr) ? h0[(static_cast<int64_t>(b) * D + d) * N + n] : 0.f;
  const int64_t row0 = static_cast<int64_t>(b) * S;

  for (int c = 0; c < NC; ++c) {
    const int t0 = c * T;
    if (states != nullptr && live)
      states[((static_cast<int64_t>(b) * NC + c) * D + d) * N + n] = h;
    __syncthreads();  // the last chunk's reads of shared memory are done
    for (int i = tid; i < T * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH, t = t0 + tt, dc = d0 + cc;
      float dv = 0.f, uv = 0.f;
      if (t < S && dc < D) {
        const int64_t at = (row0 + t) * D + dc;
        dv = softplus(dt_in[at] + dt_bias[dc]);
        uv = u[at];
      }
      s_dt[tt][cc] = dv;
      s_u[tt][cc] = uv;
    }
    for (int i = tid; i < T * NS; i += THREADS) {
      const int tt = i / NS, nn = i % NS, t = t0 + tt;
      const bool ok = t < S && nn < N;
      s_B[tt][nn] = ok ? Bm[(row0 + t) * N + nn] : 0.f;
      s_C[tt][nn] = ok ? Cm[(row0 + t) * N + nn] : 0.f;
    }
    __syncthreads();
    const int steps = S - t0 < T ? S - t0 : T;
#pragma unroll 8
    for (int tt = 0; tt < steps; ++tt) {
      const float dv = s_dt[tt][cl], uv = s_u[tt][cl];
      const float a = expf(dv * an);
      h = a * h + (dv * s_B[tt][n]) * uv;
      const float v = lane_sum(s_C[tt][n] * h);
      if (n == 0) s_y[tt][cl] = v + dd * uv;
    }
    __syncthreads();
    for (int i = tid; i < steps * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH, dc = d0 + cc;
      if (dc < D) y[(row0 + t0 + tt) * D + dc] = s_y[tt][cc];
    }
  }
  if (live) h_last[(static_cast<int64_t>(b) * D + d) * N + n] = h;
}

__global__ void __launch_bounds__(THREADS) scan_bwd(
    const float* __restrict__ u, const float* __restrict__ dt_in,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ Dsk, const float* __restrict__ states,
    const float* __restrict__ dy, const float* __restrict__ dh_last,
    float* __restrict__ du, float* __restrict__ ddt, float* __restrict__ dA_part,
    float* __restrict__ dD_part, float* __restrict__ dbias_part,
    float* __restrict__ dB_part, float* __restrict__ dC_part, float* __restrict__ dh0,
    int batch, int S, int D, int N, int NC) {
  // s_dt and s_u are overwritten in place by d dt_in and du, each slot by
  // its own channel's lane 0 after its 16 lanes have read it.
  __shared__ float s_dt[T][CH], s_sg[T][CH], s_u[T][CH], s_dy[T][CH];
  __shared__ float s_B[T][NS], s_C[T][NS];
  __shared__ float s_dB[T][WARPS][NS], s_dC[T][WARPS][NS];
  const int tid = threadIdx.x, cl = tid / NS, n = tid % NS, w = tid / 32;
  const int d0 = blockIdx.x * CH, d = d0 + cl, b = blockIdx.y;
  const bool live = d < D && n < N;
  const float an = live ? A[static_cast<int64_t>(d) * N + n] : 0.f;
  const float dd = d < D ? Dsk[d] : 0.f;
  const int64_t row0 = static_cast<int64_t>(b) * S;
  const int64_t part0 = (static_cast<int64_t>(blockIdx.x) * batch + b) * S;
  float carry = (live && dh_last != nullptr)
                    ? dh_last[(static_cast<int64_t>(b) * D + d) * N + n] : 0.f;
  float dA_acc = 0.f, dD_acc = 0.f, dbias_acc = 0.f;

  for (int c = NC - 1; c >= 0; --c) {
    const int t0 = c * T;
    const int steps = S - t0 < T ? S - t0 : T;
    __syncthreads();
    for (int i = tid; i < T * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH, t = t0 + tt, dc = d0 + cc;
      float dv = 0.f, sg = 0.f, uv = 0.f, gy = 0.f;
      if (t < S && dc < D) {
        const int64_t at = (row0 + t) * D + dc;
        const float raw = dt_in[at] + dt_bias[dc];
        dv = softplus(raw);
        sg = softplus_grad(raw);
        uv = u[at];
        gy = dy[at];
      }
      s_dt[tt][cc] = dv;
      s_sg[tt][cc] = sg;
      s_u[tt][cc] = uv;
      s_dy[tt][cc] = gy;
    }
    for (int i = tid; i < T * NS; i += THREADS) {
      const int tt = i / NS, nn = i % NS, t = t0 + tt;
      const bool ok = t < S && nn < N;
      s_B[tt][nn] = ok ? Bm[(row0 + t) * N + nn] : 0.f;
      s_C[tt][nn] = ok ? Cm[(row0 + t) * N + nn] : 0.f;
    }
    __syncthreads();

    // The chunk's states, recomputed from its start.
    const float hstart = live ? states[((static_cast<int64_t>(b) * NC + c) * D + d) * N + n] : 0.f;
    float hs[T];
    float h = hstart;
#pragma unroll
    for (int tt = 0; tt < T; ++tt) {
      if (tt < steps) {
        const float dv = s_dt[tt][cl];
        h = expf(dv * an) * h + (dv * s_B[tt][n]) * s_u[tt][cl];
      }
      hs[tt] = h;
    }

#pragma unroll
    for (int tt = T - 1; tt >= 0; --tt) {
      if (tt < steps) {
        const float dv = s_dt[tt][cl], uv = s_u[tt][cl], gy = s_dy[tt][cl];
        const float bn = s_B[tt][n];
        const float a = expf(dv * an);
        const float hprev = tt > 0 ? hs[tt - 1] : hstart;
        const float g = s_C[tt][n] * gy + carry;  // dL/dh[t]
        const float da = g * hprev;               // dL/da[t]
        dA_acc += da * a * dv;
        const float gdt = lane_sum(da * a * an + g * bn * uv);
        const float gu = lane_sum(g * (dv * bn));
        float pb = g * dv * uv, pc = gy * hs[tt];
        pb += __shfl_xor_sync(FULL, pb, 16);  // the warp's two channels
        pc += __shfl_xor_sync(FULL, pc, 16);
        if ((tid & 31) < NS) {
          s_dB[tt][w][n] = pb;
          s_dC[tt][w][n] = pc;
        }
        if (n == 0) {
          const float graw = gdt * s_sg[tt][cl];
          dbias_acc += graw;
          dD_acc += gy * uv;
          s_dt[tt][cl] = graw;
          s_u[tt][cl] = gu + dd * gy;
        }
        carry = a * g;
      }
    }
    __syncthreads();
    for (int i = tid; i < steps * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH, dc = d0 + cc;
      if (dc < D) {
        const int64_t at = (row0 + t0 + tt) * D + dc;
        ddt[at] = s_dt[tt][cc];
        du[at] = s_u[tt][cc];
      }
    }
    for (int i = tid; i < steps * NS; i += THREADS) {
      const int tt = i / NS, nn = i % NS;
      if (nn >= N) continue;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) {
        sb += s_dB[tt][k][nn];
        sc += s_dC[tt][k][nn];
      }
      dB_part[(part0 + t0 + tt) * N + nn] = sb;
      dC_part[(part0 + t0 + tt) * N + nn] = sc;
    }
  }
  if (live) {
    const int64_t at = (static_cast<int64_t>(b) * D + d) * N + n;
    dA_part[at] = dA_acc;
    if (dh0 != nullptr) dh0[at] = carry;
  }
  if (d < D && n == 0) {
    dD_part[static_cast<int64_t>(b) * D + d] = dD_acc;
    dbias_part[static_cast<int64_t>(b) * D + d] = dbias_acc;
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success); none synchronises. Every array
// is contiguous f32: u, dt_in, y, dy, du, ddt (batch, S, D); B, C (batch,
// S, N); A (D, N); dt_bias, Dsk (D); h0, h_last, dh_last, dh0, dA_part
// (batch, D, N); states (batch, ceil(S / T), D, N); dD_part, dbias_part
// (batch, D); dB_part, dC_part (ceil(D / 16), batch, S, N). h0, states,
// dh_last and dh0 may be null. 1 <= N <= 16.
extern "C" int selective_scan_chunk() { return T; }

extern "C" int selective_scan_fwd(const void* u, const void* dt_in, const void* dt_bias,
                                  const void* A, const void* Bm, const void* Cm,
                                  const void* Dsk, const void* h0, void* y, void* h_last,
                                  void* states, int64_t batch, int64_t S, int64_t D, int64_t N,
                                  void* stream) {
  if (batch <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (N < 1 || N > NS || batch > 65535 || S > 0x7fffffff || D > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = static_cast<int>((S + T - 1) / T);
  const dim3 grid(static_cast<unsigned>((D + CH - 1) / CH), static_cast<unsigned>(batch));
  scan_fwd<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(dt_in),
      static_cast<const float*>(dt_bias), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(Dsk), static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_last), static_cast<float*>(states), static_cast<int>(S),
      static_cast<int>(D), static_cast<int>(N), nc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int selective_scan_bwd(const void* u, const void* dt_in, const void* dt_bias,
                                  const void* A, const void* Bm, const void* Cm,
                                  const void* Dsk, const void* states, const void* dy,
                                  const void* dh_last, void* du, void* ddt, void* dA_part,
                                  void* dD_part, void* dbias_part, void* dB_part, void* dC_part,
                                  void* dh0, int64_t batch, int64_t S, int64_t D, int64_t N,
                                  void* stream) {
  if (batch <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (N < 1 || N > NS || batch > 65535 || S > 0x7fffffff || D > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = static_cast<int>((S + T - 1) / T);
  const dim3 grid(static_cast<unsigned>((D + CH - 1) / CH), static_cast<unsigned>(batch));
  scan_bwd<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(dt_in),
      static_cast<const float*>(dt_bias), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(Dsk), static_cast<const float*>(states),
      static_cast<const float*>(dy), static_cast<const float*>(dh_last),
      static_cast<float*>(du), static_cast<float*>(ddt), static_cast<float*>(dA_part),
      static_cast<float*>(dD_part), static_cast<float*>(dbias_part),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part), static_cast<float*>(dh0),
      static_cast<int>(batch), static_cast<int>(S), static_cast<int>(D), static_cast<int>(N),
      nc);
  return static_cast<int>(cudaGetLastError());
}

// Loads this file's kernels into the current device's context without
// launching one, so that a CUDA graph capture on that device can record a
// launch without loading a module. Call it on each device before the first
// capture there. Both kernels use static shared memory under 48 KB, so no
// per-device attribute is set.
extern "C" int selective_scan_load() {
  cudaFuncAttributes attr;
  int rc = static_cast<int>(cudaFuncGetAttributes(&attr, scan_fwd));
  if (rc == 0) rc = static_cast<int>(cudaFuncGetAttributes(&attr, scan_bwd));
  return rc;
}
