// Prefill flash attention for Hopper (sm_90a), fp32 FMA on shared-memory tiles.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_fa_kernel` in
// src/repro/kernels/flash_attention/kernel.py: causal / sliding-window GQA
// attention forward with an online softmax whose m, l and acc stay in fp32.
//
// Bound on the H100: at the serving path's shape (one 512-token prompt,
// 12 query heads over 2 KV heads, head_dim 128, bf16) the card's floor
// is about 1.1 us, set by the bytes (3.7 MB at 3.35 TB/s); the FLOPs at
// the bf16 tensor-core rate (989 TFLOP/s) take 0.8 us. This kernel does
// its products with fp32 FMAs on the CUDA cores, so its own arithmetic
// limits it to the fp32 FMA rate (67 TFLOP/s, 12 us at this shape);
// moving the two products onto wgmma/mma is the next step for speed.
//
// Design. On the TPU the grid runs in order and carries m/l/acc in VMEM
// from one kv grid step to the next. Here one CTA owns one
// (batch, kv-head, q-tile) and loops over its own KV tiles; nothing is
// carried between CTAs. A q-tile holds all g = H/Hk query heads of the
// kv head times bq rows (g*bq <= 64), so each K/V tile is loaded into
// shared memory once per group, as on the TPU. Per KV tile:
//   1. S = Q K^T from shared memory, 4x2 register micro-tiles a thread;
//   2. the causal / window / ragged-tail mask (NEG_INF = -1e30, exactly
//      as `_fa_kernel`), then the online-softmax update, 4 threads a row;
//   3. acc = acc * exp(m_prev - m_new) + P V, 4x8 register micro-tiles.
// KV tiles wholly above the causal diagonal or outside the window are
// skipped; ragged Sq and Sk tails are masked in the kernel, so no
// length has to divide a block size.
//
// Offset and ragged KV (chunked prefill and prefix resume). Optional
// per-sequence q_offset[b] and kv_len[b] (device int32, (B,)): query row
// i of sequence b sits at absolute position q_offset[b] + i, and a key
// at kpos is live iff kpos < kv_len[b] (and kpos <= qpos when causal),
// the ragged branch of `_fa_mask` in src/repro/models/layers.py. Tiles
// at or past kv_len[b], or above the tile's last absolute query
// position, are never loaded. Both absent: q_offset 0 and kv_len Sk,
// exactly the plain prefill. bf16 loads widen with
// __bfloat162float; the output is acc / max(l, 1e-30) in q's dtype.
// No TF32 and no fast-math exp: fp32 inputs meet 2e-5 against the plain
// version.
//
// Head dims. The kernel is a template on DMAX, the largest head_dim an
// instantiation takes: 128 (the serving models; its code is what it was
// before the template) and 256 (RecurrentGemma's local attention). At
// D=256 the shared memory is 140.7 KB, under the 227 KB a CTA may use,
// and each thread holds 4 x 16 fp32 accumulators. With g = 16 query
// heads over one KV head a q-tile holds only bq = 64 / g = 4 rows, so
// each K/V tile is reused by 4 query positions: slow, and accepted. At
// the training shape (B=1, S=4096, 16/1 heads, window 2048, bf16) the
// bound is the operations: 6.3 M live (query, key) pairs, 103 GFLOP,
// 0.10 ms at the bf16 tensor-core rate (1.5 ms at the fp32 FMA rate
// this kernel computes at), against 71 MB of bytes (0.02 ms).
//
// Log-sum-exp. An optional fp32 lse (B, H, Sq) output, through a
// nullable pointer as q_offset and kv_len are passed: lse = m +
// log(max(l, 1e-30)) in the scaled-score units of `_fa_forward` in
// src/repro/models/layers.py, which the training backward reads to
// recompute P blockwise. Null, nothing is written.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int ROWS = 64;    // g * bq rows of one q-tile (padded)
constexpr int BK = 32;      // KV rows per tile
constexpr int NT = 256;     // threads per CTA
constexpr int DMAX_ALL = 256;   // largest head_dim of any instantiation
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int D) {
  const int DP = D + 1;
  return sizeof(float) * (size_t)(ROWS * DP + BK * DP + BK * D + ROWS * (BK + 1) + 3 * ROWS);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, const int* __restrict__ q_offset,
              const int* __restrict__ kv_len, float* __restrict__ lse, int Sq, int Sk, int H,
              int Hk, int D, int bq, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;                   // padded stride: no bank conflicts
  float* sQ = smem;                       // [ROWS][DP]
  float* sK = sQ + ROWS * DP;             // [BK][DP]
  float* sV = sK + BK * DP;               // [BK][D]
  float* sS = sV + BK * D;                // [ROWS][BK + 1]
  float* sM = sS + ROWS * (BK + 1);       // [ROWS] running max
  float* sL = sM + ROWS;                  // [ROWS] running sum
  float* sC = sL + ROWS;                  // [ROWS] this tile's correction

  const int g = H / Hk;
  const int rows = g * bq;
  const int tid = threadIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int q_lo = blockIdx.x * bq;
  const int q_hi = min(q_lo + bq, Sq) - 1;
  const int qoff = q_offset ? q_offset[b] : 0;      // absolute position of row 0
  const int kvl = kv_len ? min(max(kv_len[b], 0), Sk) : Sk;

  // rows are g-major: row r is head kvh*g + r/bq at position q_lo + r%bq
  for (int i = tid; i < ROWS * D; i += NT) {
    const int r = i / D, d = i % D;
    float val = 0.f;
    if (r < rows) {
      const int qpos = q_lo + r % bq;
      if (qpos < Sq)
        val = to_f(q[(((size_t)b * Sq + qpos) * H + kvh * g + r / bq) * D + d]);
    }
    sQ[r * DP + d] = val;
  }
  if (tid < ROWS) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  const int rg = tid / 16;    // micro-tile rows rg*4 .. rg*4+3
  const int cg = tid % 16;    // micro-tile cols cg + 16*j
  float acc[4][DMAX / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) acc[i][j] = 0.f;

  const int nk = (kvl + BK - 1) / BK;    // no tile at or past kv_len
  for (int kt = 0; kt < nk; ++kt) {
    const int k_lo = kt * BK;
    // block-level skips (uniform across the CTA): above the diagonal,
    // or wholly older than the window for every row of the tile
    if (causal && k_lo > qoff + q_hi) break;
    if (window > 0 && qoff + q_lo - (k_lo + BK - 1) >= window) continue;
    __syncthreads();          // the previous tile is done with sK/sV/sS
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i % D, kpos = k_lo + c;
      float kx = 0.f, vx = 0.f;
      if (kpos < kvl) {
        const size_t off = (((size_t)b * Sk + kpos) * Hk + kvh) * D + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      sK[c * DP + d] = kx;
      sV[c * D + d] = vx;
    }
    __syncthreads();

    // 1. S = Q K^T * scale, masked
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(rg * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kb[j] = sK[(cg + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const int qpos = qoff + q_lo + r % bq;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = cg + 16 * j;
        const int kpos = k_lo + c;
        bool ok = kpos < kvl;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && (qpos - kpos < window);
        sS[r * (BK + 1) + c] = ok ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // 2. online softmax: 4 neighbouring lanes share one row
    {
      const int r = tid / 4, part = tid % 4;
      const float m_prev = sM[r];
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) mx = fmaxf(mx, sS[r * (BK + 1) + part + 4 * i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        const int idx = r * (BK + 1) + part + 4 * i;
        const float p = expf(sS[idx] - m_new);
        sS[idx] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sC[rg * 4 + i];
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < BK; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sS[(rg * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) {
        const int d = cg + 16 * j;
        const float vx = d < D ? sV[c * D + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vx, acc[i][j]);
      }
    }
  }
  __syncthreads();            // sL final (also when no tile was live)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (r >= rows) continue;
    const int qpos = q_lo + r % bq;
    if (qpos >= Sq) continue;
    const float den = fmaxf(sL[r], 1e-30f);
    const int head = kvh * g + r / bq;
    if (lse != nullptr && cg == 0)
      lse[((size_t)b * H + head) * Sq + qpos] = sM[r] + logf(den);
    T* out = o + (((size_t)b * Sq + qpos) * H + head) * D;
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) {
      const int d = cg + 16 * j;
      if (d < D) out[d] = from_f<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, const int* q_offset,
           const int* kv_len, float* lse, int B, int Sq, int Sk, int H, int Hk, int D,
           int causal, int window, float scale, cudaStream_t stream) {
  const int g = H / Hk;
  const int bq = ROWS / g;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + bq - 1) / bq, Hk, B);
  fa_fwd_kernel<T, DMAX><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), q_offset, kv_len, lse, Sq, Sk, H, Hk, D, bq, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, const int* q_offset,
             const int* kv_len, float* lse, int B, int Sq, int Sk, int H, int Hk, int D,
             int causal, int window, float scale, cudaStream_t stream) {
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, q_offset, kv_len, lse, B, Sq, Sk, H, Hk, D, causal,
                          window, scale, stream);
  return launch<T, 256>(q, k, v, o, q_offset, kv_len, lse, B, Sq, Sk, H, Hk, D, causal,
                        window, scale, stream);
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Sk,Hk,D), o (B,Sq,H,D), all contiguous and of one
// dtype: 0 = float32, 1 = bfloat16. q_offset and kv_len are (B,) int32
// on the device, or null for 0 and Sk; lse is (B,H,Sq) float32 on the
// device, or null. Returns a cudaError_t code (0 = ok).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const void* q_offset, const void* kv_len, void* lse,
                                   int B, int Sq, int Sk, int H, int Hk, int D, int causal,
                                   int window, float scale, int dtype, void* stream) {
  if (Hk <= 0 || H % Hk != 0 || H / Hk > ROWS || D <= 0 || D > DMAX_ALL || Sq <= 0 ||
      Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qo = static_cast<const int*>(q_offset);
  const int* kl = static_cast<const int*>(kv_len);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, qo, kl, ls, B, Sq, Sk, H, Hk, D, causal, window,
                           scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, qo, kl, ls, B, Sq, Sk, H, Hk, D, causal,
                                   window, scale, st);
  return (int)cudaErrorInvalidValue;
}
