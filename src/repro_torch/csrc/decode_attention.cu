// Decode attention for Hopper (sm_90a): split-KV flash decoding over a
// slotted cache or a paged pool.
//
// Replaces two TPU kernels in src/repro/kernels/decode_attention/kernel.py:
// `decode_attention_pallas` / `_decode_kernel` (entry decode_attention_fwd:
// one new query token per sequence against a contiguous (B, S, Hk, D) K/V
// cache) and `paged_decode_attention_pallas` / `_paged_decode_kernel`
// (entry paged_decode_attention_fwd: the same against a shared
// (N, bs, Hk, D) pool, row `pos` of sequence b at
// pool[tables[b, pos / bs], pos % bs]). Both with a valid length per
// sequence; the g = H/Hk query heads of one KV head share a single K/V
// stream; online softmax with m, l and acc in fp32.
//
// Bound on the H100: memory. A step reads every live K/V row once and
// does about 4*g flops per byte pair it reads (g = 6 for qwen2-1.5b), far
// below the ~295 flops a byte at which the card turns compute-bound. The
// floor is the live K/V bytes over 3.35 TB/s.
//
// Design. The TPU grid is (B*Hk, kv-blocks), sequential in kv, carrying
// m/l/acc in VMEM. At the serving shape B*Hk is only 16 (8 slots x 2 KV
// heads) against 132 SMs, so here the KV axis is split: one CTA per
// (split, kv-head, batch) walks its chunk of rows in tiles of 32 through
// shared memory and writes partial (m, l, acc) for its g heads; a second
// small kernel combines the splits per head. Rows and whole splits at or
// past lengths[b] are never read, so the bytes moved follow the live
// context, not the cache size. A sequence with length 0 gets zeros
// (acc / max(l, 1e-30) with l = 0), never NaN. Masked scores are
// NEG_INF = -1e30 as in `_decode_kernel`; no fast-math exp.
//
// Paged layout. One kernel body serves both layouts: a row-address
// functor maps (b, pos) to its row in the cache or the pool, and
// nothing else differs. The paged kernel follows the table row by row
// while it fills a tile, never gathering pages into a contiguous copy,
// and reads no table entry at or past lengths[b] (those pages may name
// the null block 0 or repeat a block). With the same split boundaries
// as the slotted wrapper every live row goes through the same fp32
// operations in the same order, so a paged run's tokens equal a slotted
// run's bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BKD = 32;     // KV rows per shared-memory tile (one warp wide)
constexpr int NT = 128;     // threads per CTA
constexpr int GMAX = 16;    // largest g = H / Hk taken
constexpr int DMAX = 128;   // largest head_dim taken
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// row index (in units of Hk*D elements) of sequence b's position pos
struct SlottedRows {
  int S;
  __device__ __forceinline__ size_t operator()(int b, int pos) const {
    return (size_t)b * S + pos;
  }
};
struct PagedRows {
  const int* tables;   // (B, nb) physical block per page
  int nb, bs;
  __device__ __forceinline__ size_t operator()(int b, int pos) const {
    return (size_t)tables[b * nb + pos / bs] * bs + pos % bs;
  }
};

// partials: pm/pl (B, Hk, nsplit, g), pacc (B, Hk, nsplit, g, D), fp32;
// S is the rows a sequence can address (the cache length, or nb * bs)
template <typename T, typename Rows>
__global__ void __launch_bounds__(NT)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int* __restrict__ lengths,
                      float* __restrict__ pm, float* __restrict__ pl,
                      float* __restrict__ pacc, Rows rows, int S, int H, int Hk, int D,
                      int chunk, float scale) {
  __shared__ float sQ[GMAX * DMAX];
  __shared__ float sK[BKD * (DMAX + 1)];
  __shared__ float sV[BKD * DMAX];
  __shared__ float sS[GMAX * BKD];
  __shared__ float sM[GMAX], sL[GMAX], sC[GMAX];

  const int g = H / Hk;
  const int DP = D + 1;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int len = min(max(lengths[b], 0), S);
  const int s_lo = split * chunk;
  const int s_hi = min(s_lo + chunk, len);
  const size_t part = ((size_t)b * Hk + kvh) * nsplit + split;

  // PV mapping: thread owns column d of heads hs, hs + nhs, ...
  const int nhs = NT / D;                 // >= 1 since D <= 128
  const int d_own = tid % D;
  const int hs = tid / D;
  const bool pv_thread = tid < nhs * D;

  if (s_lo >= s_hi) {                     // dead split: empty partials
    if (tid < g) {
      pm[part * g + tid] = NEG_INF;
      pl[part * g + tid] = 0.f;
    }
    for (int i = tid; i < g * D; i += NT) pacc[part * g * D + i] = 0.f;
    return;
  }

  for (int i = tid; i < g * D; i += NT)
    sQ[i] = to_f(q[((size_t)b * H + kvh * g) * D + i]);
  if (tid < g) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }
  float acc[GMAX];
#pragma unroll
  for (int i = 0; i < GMAX; ++i) acc[i] = 0.f;

  for (int t0 = s_lo; t0 < s_hi; t0 += BKD) {
    __syncthreads();                      // previous tile consumed
    for (int i = tid; i < BKD * D; i += NT) {
      const int c = i / D, d = i % D, pos = t0 + c;
      float kx = 0.f, vx = 0.f;
      if (pos < s_hi) {
        const size_t off = (rows(b, pos) * Hk + kvh) * D + d;
        kx = to_f(kc[off]);
        vx = to_f(vc[off]);
      }
      sK[c * DP + d] = kx;
      sV[c * D + d] = vx;
    }
    __syncthreads();
    // scores: entry (head gi, row c); a warp covers one head's 32 rows
    for (int e = tid; e < g * BKD; e += NT) {
      const int gi = e / BKD, c = e % BKD;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(sQ[gi * D + d], sK[c * DP + d], s);
      sS[e] = (t0 + c < s_hi) ? s * scale : NEG_INF;
    }
    __syncthreads();
    // online softmax: one warp per head, one lane per row
    for (int gi = warp; gi < g; gi += NT / 32) {
      const float m_prev = sM[gi];
      const float sv = sS[gi * BKD + lane];
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(sv - m_new);
      sS[gi * BKD + lane] = p;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sC[gi] = corr;
        sL[gi] = sL[gi] * corr + sum;
        sM[gi] = m_new;
      }
    }
    __syncthreads();
    if (pv_thread) {
#pragma unroll
      for (int i = 0; i < GMAX; ++i) {
        const int gi = hs + nhs * i;
        if (gi < g) acc[i] *= sC[gi];
      }
      for (int c = 0; c < BKD; ++c) {
        const float vx = sV[c * D + d_own];
#pragma unroll
        for (int i = 0; i < GMAX; ++i) {
          const int gi = hs + nhs * i;
          if (gi < g) acc[i] = fmaf(sS[gi * BKD + c], vx, acc[i]);
        }
      }
    }
  }
  __syncthreads();
  if (tid < g) {
    pm[part * g + tid] = sM[tid];
    pl[part * g + tid] = sL[tid];
  }
  if (pv_thread) {
#pragma unroll
    for (int i = 0; i < GMAX; ++i) {
      const int gi = hs + nhs * i;
      if (gi < g) pacc[(part * g + gi) * D + d_own] = acc[i];
    }
  }
}

// one CTA per (query head, batch); thread d owns one output column
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                                      const float* __restrict__ pacc, T* __restrict__ o, int H,
                                      int Hk, int D, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int g = H / Hk;
  const int kvh = h / g, gi = h % g;
  const size_t base = ((size_t)b * Hk + kvh) * nsplit;
  float m = NEG_INF;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, pm[(base + s) * g + gi]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(pm[(base + s) * g + gi] - m);
    l = fmaf(pl[(base + s) * g + gi], w, l);
    acc = fmaf(pacc[((base + s) * g + gi) * D + d], w, acc);
  }
  if (d < D) o[((size_t)b * H + h) * D + d] = from_f<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, typename Rows>
int launch(const void* q, const void* kc, const void* vc, const int* lengths, float* pm,
           float* pl, float* pacc, void* o, Rows rows, int B, int S, int H, int Hk, int D,
           int chunk, float scale, cudaStream_t stream) {
  const int nsplit = (S + chunk - 1) / chunk;
  dim3 grid(nsplit, Hk, B);
  decode_partial_kernel<T, Rows><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), lengths,
      pm, pl, pacc, rows, S, H, Hk, D, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<dim3(H, B), D, 0, stream>>>(pm, pl, pacc, static_cast<T*>(o), H,
                                                          Hk, D, nsplit);
  return (int)cudaGetLastError();
}

template <typename Rows>
int dispatch(const void* q, const void* kc, const void* vc, const void* lengths, void* pm,
             void* pl, void* pacc, void* o, Rows rows, int B, int S, int H, int Hk, int D,
             int chunk, float scale, int dtype, void* stream) {
  if (Hk <= 0 || H % Hk != 0 || H / Hk > GMAX || D <= 0 || D > DMAX || S <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* fm = static_cast<float*>(pm);
  float* fl = static_cast<float*>(pl);
  float* fa = static_cast<float*>(pacc);
  if (dtype == 0)
    return launch<float>(q, kc, vc, lens, fm, fl, fa, o, rows, B, S, H, Hk, D, chunk, scale,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kc, vc, lens, fm, fl, fa, o, rows, B, S, H, Hk, D, chunk,
                                 scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B,H,D), caches (B,S,Hk,D), lengths (B,) int32, o (B,H,D); q, caches
// and o share one dtype (0 = float32, 1 = bfloat16). The fp32 scratch
// pm/pl hold B*Hk*nsplit*g floats and pacc that times D, with
// nsplit = ceil(S / chunk). Returns a cudaError_t code (0 = ok).
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                                    const void* lengths, void* pm, void* pl, void* pacc,
                                    void* o, int B, int S, int H, int Hk, int D, int chunk,
                                    float scale, int dtype, void* stream) {
  return dispatch(q, kc, vc, lengths, pm, pl, pacc, o, SlottedRows{S}, B, S, H, Hk, D, chunk,
                  scale, dtype, stream);
}

// q (B,H,D), pools (N,bs,Hk,D), tables (B,nb) int32, lengths (B,) int32,
// o (B,H,D); the scratch as above with S = nb * bs. Table entries at or
// past a sequence's length are never read.
extern "C" int paged_decode_attention_fwd(const void* q, const void* kp, const void* vp,
                                          const void* tables, const void* lengths, void* pm,
                                          void* pl, void* pacc, void* o, int B, int nb, int bs,
                                          int H, int Hk, int D, int chunk, float scale,
                                          int dtype, void* stream) {
  if (nb <= 0 || bs <= 0) return (int)cudaErrorInvalidValue;
  PagedRows rows{static_cast<const int*>(tables), nb, bs};
  return dispatch(q, kp, vp, lengths, pm, pl, pacc, o, rows, B, nb * bs, H, Hk, D, chunk,
                  scale, dtype, stream);
}
