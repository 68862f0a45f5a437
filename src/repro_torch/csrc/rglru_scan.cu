// RG-LRU linear recurrence for Hopper (sm_90a), forward and reverse, fp32.
//
// Replaces the TPU kernel `rglru_scan_pallas` / `_rglru_kernel` in
// src/repro/kernels/rglru_scan/kernel.py:
//
//   forward   y_t = a_t * y_{t-1} + b_t,  y_{-1} = h0,  t = 0 .. S-1
//
// over a, b (B, S, D) and h0 (B, D). The reverse pass is the gradient of
// that scan, the same linear recurrence run from t = S-1 down to 0 with
// a shifted by one step:
//
//   g_t  = dy_t + a_{t+1} * g_{t+1}   (a_S = 0, so g_{S-1} = dy_{S-1})
//   db_t = g_t
//   da_t = g_t * y_{t-1}              (y_{-1} = h0)
//   dh0  = a_0 * g_0
//
// The TPU kernel has no backward (`jax.grad` cannot pass through a
// pallas_call), so the reference trains on its associative scan; this
// reverse pass gives the same gradient on the card.
//
// Bound on the H100: pure streaming, 2 fp ops an element. The forward
// moves 12 bytes an element (a and b read, y written), the reverse 20
// (a, dy and y read, db and da written): at B=1, S=4096, D=4096 the
// forward moves 201 MB, 0.060 ms at 3.35 TB/s, the reverse 336 MB,
// 0.100 ms.
//
// Design. On the TPU the grid walks the sequence in order and carries h
// in VMEM from one sequence block to the next. Here one thread owns one
// (batch, channel) pair and loops over the whole sequence, so the state
// lives in a register and nothing is carried between CTAs; neighbouring
// threads take neighbouring channels, so every load and store of a time
// step is coalesced across d. The loads of a_t and b_t do not depend on
// h: each thread issues UNROLL steps of loads before it runs their
// UNROLL dependent FMAs, so that many loads are in flight per thread.
// Ragged S and D tails are masked (no length has to divide a block).
// The update is one fmaf, a single rounding where the plain version
// rounds the product and the sum apart (fp32: within 1e-5 at S=4096).
//
// Known weakness: B*D channels are the only parallelism. At B=1, D=4096
// that is 32 CTAs of 128 threads on 132 SMs, so the card is a quarter
// busy and latency, not bandwidth, sets the time. A chunked two-pass
// scan over S (local scans per chunk, a carry pass, a fix-up) is the
// design that fills the card.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;       // threads per CTA: one (b, d) channel each
constexpr int UNROLL = 8;     // time steps whose loads are issued together

__global__ void __launch_bounds__(NT)
rglru_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ h0, float* __restrict__ y, int B, int S,
                 int D) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= B * D) return;
  const int bi = idx / D, d = idx % D;
  const size_t base = (size_t)bi * S * D + d;
  float h = h0[idx];
  for (int t0 = 0; t0 < S; t0 += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t < S) {
        av[u] = a[base + (size_t)t * D];
        bv[u] = b[base + (size_t)t * D];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t < S) {
        h = fmaf(av[u], h, bv[u]);
        y[base + (size_t)t * D] = h;
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ dy,
                 const float* __restrict__ y, const float* __restrict__ h0,
                 float* __restrict__ db, float* __restrict__ da,
                 float* __restrict__ dh0, int B, int S, int D) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= B * D) return;
  const int bi = idx / D, d = idx % D;
  const size_t base = (size_t)bi * S * D + d;
  const float h_init = h0[idx];
  float g = 0.f;
  float a_next = 0.f;         // a_{t+1}; a_S = 0
  for (int t0 = S - 1; t0 >= 0; t0 -= UNROLL) {
    float av[UNROLL], gv[UNROLL], yv[UNROLL];
    // unconditional loads at clamped rows (the tail past t = 0 rereads
    // row 0 and is never used): with the load under `t > 0 ? ... : h0`
    // the loads were not issued together, and the reverse took 5x the
    // forward's time on the H100
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = max(t0 - u, 0);
      av[u] = a[base + (size_t)t * D];
      gv[u] = dy[base + (size_t)t * D];
      yv[u] = y[base + (size_t)max(t - 1, 0) * D];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        g = fmaf(a_next, g, gv[u]);
        db[base + (size_t)t * D] = g;
        da[base + (size_t)t * D] = g * (t > 0 ? yv[u] : h_init);
        a_next = av[u];
      }
    }
  }
  dh0[idx] = a_next * g;      // a_0 * g_0
}

bool bad_shape(int B, int S, int D) {
  return B <= 0 || S <= 0 || D <= 0 || (long long)B * D > (1LL << 31) - 1;
}

}  // namespace

// a, b, y (B,S,D) and h0 (B,D): contiguous float32 on the device.
// Returns a cudaError_t code (0 = ok).
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* y, int B,
                              int S, int D, void* stream) {
  if (bad_shape(B, S, D)) return (int)cudaErrorInvalidValue;
  const int grid = (B * D + NT - 1) / NT;
  rglru_fwd_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y), B, S, D);
  return (int)cudaGetLastError();
}

// The reverse pass: a, dy, y (the forward's output), db, da (B,S,D) and
// h0, dh0 (B,D), contiguous float32 on the device.
extern "C" int rglru_scan_bwd(const void* a, const void* dy, const void* y, const void* h0,
                              void* db, void* da, void* dh0, int B, int S, int D,
                              void* stream) {
  if (bad_shape(B, S, D)) return (int)cudaErrorInvalidValue;
  const int grid = (B * D + NT - 1) / NT;
  rglru_bwd_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(dy),
      static_cast<const float*>(y), static_cast<const float*>(h0),
      static_cast<float*>(db), static_cast<float*>(da), static_cast<float*>(dh0), B, S, D);
  return (int)cudaGetLastError();
}
