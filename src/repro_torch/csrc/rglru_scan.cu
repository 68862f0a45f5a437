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
// 0.100 ms. Reaching that rate needs about 2 MB of loads in flight.
//
// Design: a chunked single-pass scan (a chained scan with decoupled
// look-back, as in CUB's DeviceScan). On the TPU the grid walks the
// sequence in order and carries h in VMEM; here the (B*D channels) x S
// plane is cut into tiles of L = ROWS * WARPS rows by 32 * VEC channels
// (VEC = 4, 16-byte loads, when D % 4 == 0 and every pointer is 16-byte
// aligned; else 1), one CTA a tile, so every tile's loads are in flight
// at once. A chunk of rows maps its carry-in h to A*h + Y, where A is
// the product of its a_t and Y its scan from 0, and these pairs compose:
//
//   1. The CTA takes a ticket from a counter and works on tile number
//      `ticket`, chunk-major (chunks in S order, from the last chunk in
//      reverse), so that every tile it may wait on belongs to a CTA
//      already running: no deadlock, whatever order the hardware
//      schedules blockIdx in.
//   2. Each warp loads ROWS rows of its lane's VEC channels into
//      registers and runs them from (1, 0) to its pair (A, Y); warp 0
//      composes the WARPS pairs into the chunk's aggregate and publishes
//      it (values, __threadfence, then a release store of the flag).
//   3. Warp 0 looks back over the predecessors' flags, 32 at a time, to
//      the nearest chunk that has published its inclusive carry (the
//      first chunk publishes only that, from h0, or 0 in reverse), then
//      composes the aggregates in between in chunk order:
//      h_k = fmaf(A_k, h_{k-1}, Y_k). It publishes its own inclusive
//      carry fmaf(A, h, Y) the same way.
//      Every carry is therefore the one chain over chunk pairs, however
//      far a CTA had to look back, so two calls give bitwise equal
//      results.
//   4. The warps' carries follow from the chunk's carry-in through the
//      warps' pairs; each warp rescans its rows from registers and
//      stores its outputs, 16 bytes a lane, coalesced across a row.
//
// Each element is read once and written once: the bound's bytes, plus
// 12 bytes of workspace a channel a chunk (aggregate and inclusive,
// about 1.5% at the training shape). The flags and the ticket counter
// are zeroed by a memset before each launch, so no flag of an earlier
// call is read as ready. Ragged S and D are masked (a missing row is the
// identity a = 1, b = 0 forward, a = dy = 0 in reverse); channel tiles
// never cross a batch. The updates are fmaf, a single rounding where the
// plain version rounds the product and the sum apart; a carry is a
// reassociated sum, within 1e-5 of the sequential scan at S = 4096.
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

// rows one thread walks and warps a CTA, forward and reverse; a chunk is
// ROWS * WARPS rows (the fastest of the tiles `tools/attention_sweep.py
// --scan-tiles` tried on the H100, with no spills)
constexpr int FWD_ROWS = 16, FWD_WARPS = 4, BWD_ROWS = 16, BWD_WARPS = 4;
constexpr int MIN_CTAS = 2;   // CTAs an SM, for the register budget

constexpr int NOT_READY = 0, AGGREGATE = 1, INCLUSIVE = 2;

// The workspace: a ticket counter and a flag a tile (zeroed each call),
// then a tile's aggregate (A, Y) and inclusive carry, DC floats each.
struct Work {
  int* ticket;
  int* flag;
  float* agg_a;
  float* agg_y;
  float* incl;
};

struct Plan {
  int n_dt, n_ct, n_chunks, n_tiles, dc;
  size_t zero_bytes, bytes;
};

Plan plan(int B, int S, int D, int vec, int rows) {
  Plan p;
  p.dc = 32 * vec;
  p.n_dt = (D + p.dc - 1) / p.dc;
  p.n_ct = B * p.n_dt;
  p.n_chunks = (S + rows - 1) / rows;
  p.n_tiles = p.n_ct * p.n_chunks;
  p.zero_bytes = sizeof(int) * (1 + (size_t)p.n_tiles);
  const size_t floats = (size_t)p.n_tiles * p.dc;
  p.bytes = (p.zero_bytes + 255) / 256 * 256 + 3 * floats * sizeof(float);
  return p;
}

Work carve(void* ws, const Plan& p) {
  char* base = static_cast<char*>(ws);
  const size_t floats = (size_t)p.n_tiles * p.dc;
  float* f = reinterpret_cast<float*>(base + (p.zero_bytes + 255) / 256 * 256);
  return {reinterpret_cast<int*>(base), reinterpret_cast<int*>(base) + 1, f,
          f + floats, f + 2 * floats};
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// Warp 0: write this lane's channels of a tile's pair (or of its carry,
// with y == nullptr) past L1, then flag the tile with a release.
template <int VEC>
__device__ __forceinline__ void publish(float* a, float* y, const float (&va)[VEC],
                                        const float (&vy)[VEC], int* flag, int state,
                                        int lane) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    __stcg(a + v, va[v]);
    if (y) __stcg(y + v, vy[v]);
  }
  __threadfence();
  __syncwarp();
  if (lane == 0) st_release(flag, state);
}

// Warp 0: the carry into `chunk` of channel tile `ct`, into h.
// Predecessors lie at chunk + step*k, k >= 1; the walk stops at the
// nearest one that is inclusive (the scan's first chunk publishes only
// its inclusive carry, so there is always one) and composes the
// aggregates after it in chunk order.
template <int VEC>
__device__ __forceinline__ void look_back(const Work& w, int ct, int chunk, int n_chunks,
                                          int step, int lane, int dc, float (&h)[VEC]) {
  const int* flags = w.flag + (size_t)ct * n_chunks;
  int k0 = 1, dist;
  for (;;) {
    const int j = chunk + step * (k0 + lane);
    // lanes past the first chunk see it as inclusive; they follow it
    const int f = (j < 0 || j >= n_chunks) ? INCLUSIVE : ld_acquire(flags + j);
    const unsigned incl = __ballot_sync(~0u, f == INCLUSIVE);
    const unsigned wait = __ballot_sync(~0u, f == NOT_READY);
    if (incl) {
      const int first = __ffs(incl) - 1;
      if (!(wait & ((1u << first) - 1u))) {
        dist = k0 + first;
        break;
      }
    } else if (!wait) {
      k0 += 32;       // 32 aggregates: look further back
      continue;
    }
    __nanosleep(32);
  }
  __threadfence();
  const size_t lane_off = (size_t)lane * VEC;
  const float* src = w.incl + ((size_t)ct * n_chunks + chunk + step * dist) * dc + lane_off;
#pragma unroll
  for (int v = 0; v < VEC; ++v) h[v] = __ldcg(src + v);
  constexpr int U = 2;   // aggregates loaded ahead of their fmaf chain
  for (int k = dist - 1; k >= 1; k -= U) {
    float pa[U][VEC], py[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k - u >= 1) {
        const size_t off = ((size_t)ct * n_chunks + chunk + step * (k - u)) * dc + lane_off;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          pa[u][v] = __ldcg(w.agg_a + off + v);
          py[u][v] = __ldcg(w.agg_y + off + v);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k - u >= 1) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) h[v] = fmaf(pa[u][v], h[v], py[u][v]);
      }
    }
  }
}

// Warp 0, after every warp's pair is in s_a / s_y: the chunk's aggregate
// (warps composed in scan order: ascending, or descending in reverse),
// its carry-in by look-back (`start` for the chunk that begins the
// scan), its inclusive carry, and each warp's carry-in into s_h.
template <int VEC, int WARPS, bool REV>
__device__ __forceinline__ void carry(const Work& w, float (*s_a)[32 * VEC],
                                      float (*s_y)[32 * VEC], float (*s_h)[32 * VEC],
                                      int ct, int chunk, int n_chunks, int lane,
                                      const float (&start)[VEC]) {
  constexpr int DC = 32 * VEC;
  const int c = lane * VEC;
  const auto order = [](int i) { return REV ? WARPS - 1 - i : i; };
  float ca[VEC], cy[VEC], h[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) ca[v] = s_a[order(0)][c + v], cy[v] = s_y[order(0)][c + v];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      cy[v] = fmaf(s_a[order(i)][c + v], cy[v], s_y[order(i)][c + v]);
      ca[v] *= s_a[order(i)][c + v];
    }
  }
  const size_t tile = (size_t)ct * n_chunks + chunk;
  const size_t slot = tile * DC + c;
  if (chunk == (REV ? n_chunks - 1 : 0)) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) h[v] = start[v];
  } else {
    publish<VEC>(w.agg_a + slot, w.agg_y + slot, ca, cy, w.flag + tile, AGGREGATE, lane);
    look_back<VEC>(w, ct, chunk, n_chunks, REV ? 1 : -1, lane, DC, h);
  }
  float hi[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) hi[v] = fmaf(ca[v], h[v], cy[v]);
  publish<VEC>(w.incl + slot, nullptr, hi, hi, w.flag + tile, INCLUSIVE, lane);
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      s_h[order(i)][c + v] = h[v];
      h[v] = fmaf(s_a[order(i)][c + v], h[v], s_y[order(i)][c + v]);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(FWD_WARPS * 32, MIN_CTAS)
rglru_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ h0, float* __restrict__ y, Work w, int S,
                 int D, int n_chunks, int n_dt, int n_ct) {
  constexpr int R = FWD_ROWS, DC = 32 * VEC;
  __shared__ float s_a[FWD_WARPS][DC], s_y[FWD_WARPS][DC], s_h[FWD_WARPS][DC];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(w.ticket, 1);
  __syncthreads();
  const int chunk = s_tile / n_ct, ct = s_tile % n_ct;
  const int bi = ct / n_dt, d = (ct % n_dt) * DC + lane * VEC;
  const bool col = d < D;
  const int row0 = chunk * (R * FWD_WARPS) + warp * R;
  const size_t base = ((size_t)bi * S + row0) * D + d;
  float av[R][VEC], bv[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (col && row0 + r < S) {
      load<VEC>(a + base + (size_t)r * D, av[r]);
      load<VEC>(b + base + (size_t)r * D, bv[r]);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) av[r][v] = 1.f, bv[r][v] = 0.f;
    }
  }
  float pa[VEC], py[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) pa[v] = 1.f, py[v] = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      py[v] = fmaf(av[r][v], py[v], bv[r][v]);
      pa[v] *= av[r][v];
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) s_a[warp][lane * VEC + v] = pa[v], s_y[warp][lane * VEC + v] = py[v];
  __syncthreads();
  if (warp == 0) {
    float start[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) start[v] = 0.f;
    if (chunk == 0 && col) load<VEC>(h0 + (size_t)bi * D + d, start);
    carry<VEC, FWD_WARPS, false>(w, s_a, s_y, s_h, ct, chunk, n_chunks, lane, start);
  }
  __syncthreads();
  float h[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) h[v] = s_h[warp][lane * VEC + v];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) h[v] = fmaf(av[r][v], h[v], bv[r][v]);
    if (col && row0 + r < S) store<VEC>(y + base + (size_t)r * D, h);
  }
}

template <int VEC>
__global__ void __launch_bounds__(BWD_WARPS * 32, MIN_CTAS)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ dy,
                 const float* __restrict__ y, const float* __restrict__ h0,
                 float* __restrict__ db, float* __restrict__ da, float* __restrict__ dh0,
                 Work w, int S, int D, int n_chunks, int n_dt, int n_ct) {
  constexpr int R = BWD_ROWS, DC = 32 * VEC;
  __shared__ float s_a[BWD_WARPS][DC], s_y[BWD_WARPS][DC], s_h[BWD_WARPS][DC];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(w.ticket, 1);
  __syncthreads();
  const int chunk = n_chunks - 1 - s_tile / n_ct, ct = s_tile % n_ct;
  const int bi = ct / n_dt, d = (ct % n_dt) * DC + lane * VEC;
  const bool col = d < D;
  const int row0 = chunk * (R * BWD_WARPS) + warp * R;
  const size_t base = ((size_t)bi * S + row0) * D + d;
  // an: a_{t+1} (0 from t = S-1 on), gv: dy_t, yp: y_{t-1} (h0 at t = 0)
  float an[R][VEC], gv[R][VEC], yp[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = row0 + r;
    const size_t at = base + (size_t)r * D;
    if (col && t + 1 < S) {
      load<VEC>(a + at + D, an[r]);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) an[r][v] = 0.f;
    }
    if (col && t < S) {
      load<VEC>(dy + at, gv[r]);
      if (t > 0) load<VEC>(y + at - D, yp[r]);
      else load<VEC>(h0 + (size_t)bi * D + d, yp[r]);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) gv[r][v] = 0.f, yp[r][v] = 0.f;
    }
  }
  float pa[VEC], py[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) pa[v] = 1.f, py[v] = 0.f;
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      py[v] = fmaf(an[r][v], py[v], gv[r][v]);
      pa[v] *= an[r][v];
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) s_a[warp][lane * VEC + v] = pa[v], s_y[warp][lane * VEC + v] = py[v];
  __syncthreads();
  if (warp == 0) {
    float start[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) start[v] = 0.f;
    carry<VEC, BWD_WARPS, true>(w, s_a, s_y, s_h, ct, chunk, n_chunks, lane, start);
  }
  __syncthreads();
  float g[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) g[v] = s_h[warp][lane * VEC + v];
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    float gd[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      g[v] = fmaf(an[r][v], g[v], gv[r][v]);
      gd[v] = g[v] * yp[r][v];
    }
    if (col && row0 + r < S) {
      store<VEC>(db + base + (size_t)r * D, g);
      store<VEC>(da + base + (size_t)r * D, gd);
    }
  }
  if (row0 == 0 && col) {     // g is g_0 now: dh0 = a_0 * g_0
    float a0[VEC];
    load<VEC>(a + base, a0);
#pragma unroll
    for (int v = 0; v < VEC; ++v) a0[v] *= g[v];
    store<VEC>(dh0 + (size_t)bi * D + d, a0);
  }
}

bool bad_shape(int B, int S, int D) {
  return B <= 0 || S <= 0 || D <= 0 || (long long)B * D > (1LL << 31) - 1;
}

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// The workspace either body may need (its 16-byte or its scalar path).
size_t workspace_bytes(int B, int S, int D, int rows) {
  const size_t v4 = plan(B, S, D, 4, rows).bytes, v1 = plan(B, S, D, 1, rows).bytes;
  return v4 > v1 ? v4 : v1;
}

template <typename Launch>
int launch(const Plan& p, void* ws, long long ws_bytes, cudaStream_t stream, Launch go) {
  if ((long long)p.bytes > ws_bytes || p.n_tiles <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(ws, 0, p.zero_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  go(carve(ws, p));
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of device workspace that rglru_scan_fwd (reverse = 0) or
// rglru_scan_bwd (reverse = 1) needs at this shape, into *bytes.
// Returns a cudaError_t code (0 = ok).
extern "C" int rglru_scan_workspace(int B, int S, int D, int reverse, long long* bytes) {
  if (bad_shape(B, S, D) || !bytes) return (int)cudaErrorInvalidValue;
  *bytes = (long long)workspace_bytes(B, S, D,
                                      reverse ? BWD_ROWS * BWD_WARPS : FWD_ROWS * FWD_WARPS);
  return 0;
}

// a, b, y (B,S,D) and h0 (B,D): contiguous float32 on the device; ws: at
// least rglru_scan_workspace(B, S, D, 0) bytes on the device, 256-byte
// aligned. Returns a cudaError_t code (0 = ok).
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* y, void* ws,
                              long long ws_bytes, int B, int S, int D, void* stream) {
  if (bad_shape(B, S, D)) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto fa = static_cast<const float*>(a), fb = static_cast<const float*>(b),
             fh = static_cast<const float*>(h0);
  const auto fy = static_cast<float*>(y);
  if (D % 4 == 0 && aligned16({a, b, h0, y})) {
    const Plan p = plan(B, S, D, 4, FWD_ROWS * FWD_WARPS);
    return launch(p, ws, ws_bytes, st, [&](Work w) {
      rglru_fwd_kernel<4><<<p.n_tiles, FWD_WARPS * 32, 0, st>>>(fa, fb, fh, fy, w, S, D,
                                                                p.n_chunks, p.n_dt, p.n_ct);
    });
  }
  const Plan p = plan(B, S, D, 1, FWD_ROWS * FWD_WARPS);
  return launch(p, ws, ws_bytes, st, [&](Work w) {
    rglru_fwd_kernel<1><<<p.n_tiles, FWD_WARPS * 32, 0, st>>>(fa, fb, fh, fy, w, S, D,
                                                              p.n_chunks, p.n_dt, p.n_ct);
  });
}

// The reverse pass: a, dy, y (the forward's output), db, da (B,S,D) and
// h0, dh0 (B,D), contiguous float32 on the device; ws: at least
// rglru_scan_workspace(B, S, D, 1) bytes, 256-byte aligned.
extern "C" int rglru_scan_bwd(const void* a, const void* dy, const void* y, const void* h0,
                              void* db, void* da, void* dh0, void* ws, long long ws_bytes,
                              int B, int S, int D, void* stream) {
  if (bad_shape(B, S, D)) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto fa = static_cast<const float*>(a), fdy = static_cast<const float*>(dy),
             fy = static_cast<const float*>(y), fh = static_cast<const float*>(h0);
  const auto fdb = static_cast<float*>(db), fda = static_cast<float*>(da),
             fdh = static_cast<float*>(dh0);
  if (D % 4 == 0 && aligned16({a, dy, y, h0, db, da, dh0})) {
    const Plan p = plan(B, S, D, 4, BWD_ROWS * BWD_WARPS);
    return launch(p, ws, ws_bytes, st, [&](Work w) {
      rglru_bwd_kernel<4><<<p.n_tiles, BWD_WARPS * 32, 0, st>>>(
          fa, fdy, fy, fh, fdb, fda, fdh, w, S, D, p.n_chunks, p.n_dt, p.n_ct);
    });
  }
  const Plan p = plan(B, S, D, 1, BWD_ROWS * BWD_WARPS);
  return launch(p, ws, ws_bytes, st, [&](Work w) {
    rglru_bwd_kernel<1><<<p.n_tiles, BWD_WARPS * 32, 0, st>>>(
        fa, fdy, fy, fh, fdb, fda, fdh, w, S, D, p.n_chunks, p.n_dt, p.n_ct);
  });
}
