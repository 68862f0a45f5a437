// Prefill flash attention for Hopper (sm_90a): a tensor-core body for
// bf16 and an fp32 FMA body for fp32, chosen by dtype at the entry.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_fa_kernel` in
// src/repro/kernels/flash_attention/kernel.py: causal / sliding-window GQA
// attention forward with an online softmax whose m, l and acc stay in fp32.
//
// Which body serves which dtype, and why. bf16 inputs (every serving and
// training call) run `fa_fwd_tc_kernel`: both products on the tensor
// cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate). fp32 inputs
// run `fa_fwd_kernel`, the FMA body of the first port, unchanged: with
// TF32 off it is the only way to keep the fp32 golden fixtures at 2e-5,
// and no main path sends fp32. A bf16 call never reaches the FMA body,
// and nothing falls back from one body to the other.
//
// Bound on the H100. Serving prefill (one 512-token prompt, 12 query
// heads over 2 KV heads, head_dim 128): about 1.1 us, set by the bytes
// (3.7 MB at 3.35 TB/s); the FLOPs at 989 TFLOP/s take 0.8 us. Training
// (B=1, S=4096, 16/1 heads, head_dim 256, window 2048): the operations,
// 6.3 M live (query, key) pairs, 103 GFLOP, 0.10 ms at 989 TFLOP/s.
//
// Tensor-core body (bf16). One CTA of 4 warps per (batch, query head,
// q-tile of BQ = 64 positions), 16 query rows a warp. Query head h reads
// KV head h / g; the g heads of a group sit next to each other in the
// grid, so they reread the same K/V tiles from the 50 MB L2 at about
// the same time. BQ = 64 rather than 128: the fifo prefill (B=1, 512
// positions, 12 heads) then has 96 CTAs instead of 48 on 132 SMs, and
// at g = 16 every K/V tile still feeds 64 positions (the first port
// split 64 rows over the group: 4 positions a tile at g = 16). The grid
// runs the q-tiles with the most live KV tiles first (causal imbalance).
// Per KV tile:
//   1. S = Q K^T on mma.sync m16n8k16 fed by ldmatrix from shared
//      memory. Q's fragments stay in registers at head_dim <= 128; at
//      256 they are reread from shared memory (registers hold O).
//   2. The causal / window / ragged mask (NEG_INF = -1e30, exactly as
//      `_fa_kernel`; only on tiles the mask can reach), then the online
//      softmax in fp32 with the row max shared over the 4 lanes of a
//      quad.
//   3. O = O * exp(m_prev - m_new) + P V at the TPU kernel's precision,
//      which multiplies an fp32 P by V: each P fragment is split into
//      two bf16 fragments, hi = bf16(P) and lo = bf16(P - hi), in
//      registers (the S accumulator's layout is the A operand's, as in
//      FlashAttention-2), and P V is issued twice into the same fp32
//      accumulator, hi V then lo V. P then carries about 16 bits of
//      mantissa into O (bf16 alone carried 8, while l summed the
//      unrounded P: numerator and denominator disagreed by P's rounding,
//      a one-ulp miss of the output on rows over one to three keys). V's
//      fragments come from ldmatrix.trans. m, l and O stay fp32; l sums
//      the unrounded P. O is rescaled only when a row max of the warp
//      moved (a factor of exactly 1 skipped). P V's share of the mma
//      work doubles: a third of the tile's mma instead of a half.
// The next k-step's (or 16 columns') fragments are loaded while the
// current ones multiply, so an mma seldom waits on its ldmatrix; exp is
// ex2.approx (relative error ~2^-22, below what hi + lo carries).
// Loads: K/V tiles (BK = 64 rows at head_dim <= 128; 32 at 256, where O
// takes 128 registers a thread) move with 16-byte cp.async into a ring
// of 2 stages, the next tile in flight while this one computes; Q comes
// with the first tile. Of the rings tried on the H100 (32 or 64 rows, 2
// to 4 stages; tools/attention_sweep.py) this one was fastest at both
// the serving and the training shapes: a deeper ring costs the second
// CTA on an SM. Tiles stay bf16 in shared memory with rows padded
// by 16 bytes, so the 8 rows an ldmatrix phase reads fall in 8 distinct
// bank groups. Shared memory: 85 KB at head_dim 128, 99 KB at 256, so
// two CTAs share an SM. A head_dim that is not a multiple of 16 is
// zero-padded in shared memory to the next one; a head_dim that is not a
// multiple of 8, or a base pointer that is not 16-byte aligned, loads
// element by element (the same body otherwise). The KV loop runs from
// the first tile the window reaches to the last below the diagonal and
// kv_len: no other tile is loaded. Rows past Sq, Sk or kv_len are
// zero-filled by cp.async (nothing is read), and padding columns are
// never written back.
//
// FMA body (fp32). One CTA owns one (batch, kv-head, q-tile) and loops
// over its own KV tiles; nothing is carried between CTAs. A q-tile holds
// all g = H/Hk query heads of the kv head times bq rows (g*bq <= 64), so
// each K/V tile is loaded into shared memory once per group. Per KV
// tile:
//   1. S = Q K^T from shared memory, 4x2 register micro-tiles a thread;
//   2. the causal / window / ragged-tail mask (NEG_INF = -1e30, exactly
//      as `_fa_kernel`), then the online-softmax update, 4 threads a row;
//   3. acc = acc * exp(m_prev - m_new) + P V, 4x8 register micro-tiles.
// KV tiles wholly above the causal diagonal or outside the window are
// skipped; ragged Sq and Sk tails are masked in the kernel. No TF32 and
// no fast-math exp: fp32 inputs meet 2e-5 against the plain version. It
// is a template on DMAX, the largest head_dim an instantiation takes
// (128 and 256; 140.7 KB of shared memory at 256).
//
// Offset and ragged KV (chunked prefill and prefix resume), both bodies.
// Optional per-sequence q_offset[b] and kv_len[b] (device int32, (B,)):
// query row i of sequence b sits at absolute position q_offset[b] + i,
// and a key at kpos is live iff kpos < kv_len[b] (and kpos <= qpos when
// causal), the ragged branch of `_fa_mask` in src/repro/models/layers.py.
// Both absent: q_offset 0 and kv_len Sk, exactly the plain prefill. The
// output is acc / max(l, 1e-30) in q's dtype. A sequence's result does
// not depend on B or on the other sequences: every CTA reads one
// sequence only, in a fixed order of operations.
//
// Log-sum-exp, both bodies. An optional fp32 lse (B, H, Sq) output,
// through a nullable pointer as q_offset and kv_len are passed: lse = m +
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
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// the tensor-core body (bf16)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64;          // query positions a CTA: 4 warps x 16 rows
constexpr int NW = 4;
constexpr int NTC = 32 * NW;
constexpr float L2E = 1.4426950408889634f;

// KV rows a tile (BK) and tiles in the ring (NS) for each instantiation
template <int DMAX> struct Tile;
template <> struct Tile<128> { static constexpr int BK = 64, NS = 2; };
template <> struct Tile<256> { static constexpr int BK = 32, NS = 2; };

// shared-memory row stride in elements: head_dim rounded up to 16, plus
// 8 (16 bytes), so consecutive rows start 16 bytes apart modulo 128
__host__ __device__ __forceinline__ int row_stride(int D) { return ((D + 15) & ~15) + 8; }

template <int DMAX>
size_t smem_bytes(int D) {
  return sizeof(bf16) * (size_t)row_stride(D) * (BQ + 2 * Tile<DMAX>::NS * Tile<DMAX>::BK);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; pred false zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16 row-major) * b (16x8 col-major), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x: ex2.approx (relative error ~2^-22; 0 and 1 exact), flushing
// results below 2^-126 to 0 -- against a row max of exactly 1, such P
// add nothing that the fp32 sums could hold
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values as a bf16 pair `hi` (x rounded) and a bf16 pair `lo`
// (the remainder x - hi, rounded): hi + lo holds x to about 16 bits
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// rows [row0, row0 + R) of one head of one sequence into dst (stride SD);
// `src` is the sequence's row 0 at that head, `stride` the elements
// between rows. Rows at or past `nrows` are zero-filled, never read.
// CMAX = DMAX / 8 chunks a row at most, so the vector path's index
// arithmetic is shifts.
template <int R, int CMAX>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int nrows,
                                          size_t stride, int D, int SD, bool vec) {
  static_assert((R * CMAX) % NTC == 0, "a tile is whole chunks a thread");
  if (vec) {                    // D % 8 == 0, 16-byte aligned: cp.async
#pragma unroll
    for (int j = 0; j < R * CMAX / NTC; ++j) {
      const int i = j * NTC + threadIdx.x;
      const int r = i / CMAX, c = i % CMAX;
      if (c * 8 >= D) continue;
      const bool ok = row0 + r < nrows;
      const bf16* s = ok ? src + (size_t)(row0 + r) * stride + c * 8 : src;
      cp_async16(dst + r * SD + c * 8, s, ok);
    }
  } else {                      // element by element, synchronous
    for (int i = threadIdx.x; i < R * D; i += NTC) {
      const int r = i / D, d = i % D;
      dst[r * SD + d] = row0 + r < nrows ? src[(size_t)(row0 + r) * stride + d]
                                         : __float2bfloat16(0.f);
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(NTC, 2)
fa_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 const int* __restrict__ q_offset, const int* __restrict__ kv_len,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hk, int D, int causal,
                 int window, float scale, int vec) {
  constexpr int BK = Tile<DMAX>::BK;
  constexpr int NS = Tile<DMAX>::NS;
  constexpr int CMAX = DMAX / 8;
  constexpr int NKS = DMAX / 16;    // k-steps over d of S = Q K^T
  constexpr int NST = BK / 8;       // 8-key n-tiles of S
  constexpr int NDT = DMAX / 8;     // 8-column n-tiles of O
  constexpr bool QREG = DMAX <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SD = row_stride(D);
  const int D16 = SD - 8;
  const int nks = D16 / 16;         // the k-steps (and 16-column pairs) in use
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);     // [BQ][SD]
  bf16* sKV = sQ + BQ * SD;                          // NS x {K [BK][SD], V [BK][SD]}

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / Hk);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest q-tiles first
  const int q_hi = min(q_lo + BQ, Sq) - 1;
  const int qoff = q_offset ? q_offset[b] : 0;
  const int kvl = kv_len ? min(max(kv_len[b], 0), Sk) : Sk;

  // the live KV tiles: from the first the window reaches to the last at
  // or below the diagonal and below kv_len
  int kt_lo = 0, kt_hi = (kvl + BK - 1) / BK;
  if (causal) {
    const int last = qoff + q_hi;
    kt_hi = last < 0 ? 0 : min(kt_hi, last / BK + 1);
  }
  if (window > 0) {
    const int first = qoff + q_lo - window + 1;
    if (first > 0) kt_lo = first / BK;
  }

  // padding columns [D, D16) of every buffer are zero for the whole run
  if (D16 > D)
    for (int i = tid; i < (BQ + 2 * NS * BK) * (D16 - D); i += NTC)
      sQ[(i / (D16 - D)) * SD + D + i % (D16 - D)] = __float2bfloat16(0.f);

  const size_t kv_stride = (size_t)Hk * D;
  const bf16* kseq = k + ((size_t)b * Sk * Hk + kvh) * D;
  const bf16* vseq = v + ((size_t)b * Sk * Hk + kvh) * D;
  // Q and the first NS - 1 tiles in flight before any is consumed; one
  // commit group a tile (Q rides with the first)
  load_rows<BQ, CMAX>(sQ, q + ((size_t)b * Sq * H + h) * D, q_lo, Sq, (size_t)H * D, D, SD,
                      vec);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (kt_lo + i < kt_hi) {
      bf16* nK = sKV + i * 2 * BK * SD;
      load_rows<BK, CMAX>(nK, kseq, (kt_lo + i) * BK, kvl, kv_stride, D, SD, vec);
      load_rows<BK, CMAX>(nK + BK * SD, vseq, (kt_lo + i) * BK, kvl, kv_stride, D, SD, vec);
    }
    cp_commit();
  }

  const int wrow = warp * 16;                    // this warp's rows of the tile
  const int qpos0 = qoff + q_lo + wrow + gid;    // absolute positions of its
  const int qpos1 = qpos0 + 8;                   // two rows a thread
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  unsigned qf[QREG ? NKS : 1][4];

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int it = kt - kt_lo;
    const bf16* sK = sKV + (it % NS) * 2 * BK * SD;
    const bf16* sV = sK + BK * SD;
    __syncthreads();              // tile it - 1 consumed: its stage is free
    if (kt + NS - 1 < kt_hi) {
      bf16* nK = sKV + ((it + NS - 1) % NS) * 2 * BK * SD;
      load_rows<BK, CMAX>(nK, kseq, (kt + NS - 1) * BK, kvl, kv_stride, D, SD, vec);
      load_rows<BK, CMAX>(nK + BK * SD, vseq, (kt + NS - 1) * BK, kvl, kv_stride, D, SD, vec);
    }
    cp_commit();
    cp_wait<NS - 1>();            // this tile (and Q) have landed
    __syncthreads();
    if (QREG && kt == kt_lo) {
#pragma unroll
      for (int ks = 0; ks < (QREG ? NKS : 1); ++ks)
        if (ks < nks) ldsm_x4(qf[ks], sQ + (wrow + lane % 16) * SD + ks * 16 + (lane / 16) * 8);
    }

    // 1. S = Q K^T; the fragments of k-step ks + 1 load while ks multiplies
    float s[NST][4];
#pragma unroll
    for (int j = 0; j < NST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    unsigned kb[2][NST / 2][4], qa[2][4];
    auto load_ks = [&](int ks, unsigned (&kd)[NST / 2][4], unsigned (&qd)[4]) {
      if constexpr (!QREG)
        ldsm_x4(qd, sQ + (wrow + lane % 16) * SD + ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NST / 2; ++np)
        ldsm_x4(kd[np], sK + (np * 16 + (lane / 16) * 8 + lane % 8) * SD + ks * 16 +
                            ((lane / 8) % 2) * 8);
    };
    load_ks(0, kb[0], qa[0]);
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      if (ks >= nks) break;
      if (ks + 1 < nks) load_ks(ks + 1, kb[(ks + 1) % 2], qa[(ks + 1) % 2]);
      const unsigned(&a)[4] = QREG ? qf[QREG ? ks : 0] : qa[ks % 2];
#pragma unroll
      for (int np = 0; np < NST / 2; ++np) {
        mma16816(s[2 * np], a, kb[ks % 2][np][0], kb[ks % 2][np][1]);
        mma16816(s[2 * np + 1], a, kb[ks % 2][np][2], kb[ks % 2][np][3]);
      }
    }

    // 2. scale and mask (only where the mask can reach this warp's
    // rows), then the online softmax; a row's 4 lanes share its max
    const int k_lo = kt * BK;
    const bool masked = k_lo + BK > kvl || (causal && k_lo + BK - 1 > qpos0 - gid) ||
                        (window > 0 && qpos0 - gid + 15 - k_lo >= window);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked) {
          const int kpos = k_lo + j * 8 + tig * 2 + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          bool ok = kpos < kvl;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && (qpos - kpos < window);
          x = ok ? x : NEG_INF;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2_approx((m0 - mn0) * L2E), c1 = exp2_approx((m1 - mn1) * L2E);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NST; ++j) {
      s[j][0] = exp2_approx((s[j][0] - mn0) * L2E);
      s[j][1] = exp2_approx((s[j][1] - mn0) * L2E);
      s[j][2] = exp2_approx((s[j][2] - mn1) * L2E);
      s[j][3] = exp2_approx((s[j][3] - mn1) * L2E);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + sum0;          // this lane's part of the row sums
    l1 = l1 * c1 + sum1;
    if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {   // a row max moved
#pragma unroll
      for (int j = 0; j < NDT; ++j) {
        acc[j][0] *= c0;
        acc[j][1] *= c0;
        acc[j][2] *= c1;
        acc[j][3] *= c1;
      }
    }

    // 3. O += P V with P as hi + lo, two bf16 fragments in registers,
    // each multiplied by V into the same fp32 accumulator; V's fragments
    // for the next 16 columns load while these multiply
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned pa[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], pa[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], pa[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3], pl[3]);
      const bf16* vrow = sV + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * SD + (lane / 16) * 8;
      unsigned vb[2][4];
      ldsm_x4_t(vb[0], vrow);
#pragma unroll
      for (int dp = 0; dp < NKS; ++dp) {
        if (dp >= nks) break;
        if (dp + 1 < nks) ldsm_x4_t(vb[(dp + 1) % 2], vrow + (dp + 1) * 16);
        mma16816(acc[2 * dp], pa, vb[dp % 2][0], vb[dp % 2][1]);
        mma16816(acc[2 * dp], pl, vb[dp % 2][0], vb[dp % 2][1]);
        mma16816(acc[2 * dp + 1], pa, vb[dp % 2][2], vb[dp % 2][3]);
        mma16816(acc[2 * dp + 1], pl, vb[dp % 2][2], vb[dp % 2][3]);
      }
    }
  }
  cp_wait<0>();                   // nothing in flight at exit

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = q_lo + wrow + gid + 8 * half;
    if (qpos >= Sq) continue;
    const float den = half ? den1 : den0;
    if (lse != nullptr && tig == 0)
      lse[((size_t)b * H + h) * Sq + qpos] = (half ? m1 : m0) + logf(den);
    bf16* out = o + (((size_t)b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      const int d = j * 8 + tig * 2;
      if (d >= D) break;
      const float x0 = acc[j][2 * half] / den, x1 = acc[j][2 * half + 1] / den;
      if (d + 1 < D && D % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        out[d] = __float2bfloat16(x0);
        if (d + 1 < D) out[d + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, const int* q_offset,
           const int* kv_len, float* lse, int B, int Sq, int Sk, int H, int Hk, int D,
           int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DMAX>(D);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_tc_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k) |
                         reinterpret_cast<size_t>(v)) % 16) == 0;
  const int vec = D % 8 == 0 && aligned;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  fa_fwd_tc_kernel<DMAX><<<grid, NTC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), q_offset, kv_len, lse, Sq, Sk, H, Hk, D, causal, window, scale,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int DMAX>
int launch_fma(const void* q, const void* k, const void* v, void* o, const int* q_offset,
               const int* kv_len, float* lse, int B, int Sq, int Sk, int H, int Hk, int D,
               int causal, int window, float scale, cudaStream_t stream) {
  const int g = H / Hk;
  const int bq = ROWS / g;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<float, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + bq - 1) / bq, Hk, B);
  fa_fwd_kernel<float, DMAX><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), q_offset, kv_len, lse, Sq, Sk, H,
      Hk, D, bq, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Sk,Hk,D), o (B,Sq,H,D), all contiguous and of one
// dtype: 0 = float32 (the FMA body; H/Hk <= 64), 1 = bfloat16 (the
// tensor-core body; any H/Hk). q_offset and kv_len are (B,) int32 on the
// device, or null for 0 and Sk; lse is (B,H,Sq) float32 on the device,
// or null. Returns a cudaError_t code (0 = ok).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const void* q_offset, const void* kv_len, void* lse,
                                   int B, int Sq, int Sk, int H, int Hk, int D, int causal,
                                   int window, float scale, int dtype, void* stream) {
  if (Hk <= 0 || H % Hk != 0 || D <= 0 || D > DMAX_ALL || B <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qo = static_cast<const int*>(q_offset);
  const int* kl = static_cast<const int*>(kv_len);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0) {
    if (H / Hk > ROWS) return (int)cudaErrorInvalidValue;
    return D <= 128 ? launch_fma<128>(q, k, v, o, qo, kl, ls, B, Sq, Sk, H, Hk, D, causal,
                                      window, scale, st)
                    : launch_fma<256>(q, k, v, o, qo, kl, ls, B, Sq, Sk, H, Hk, D, causal,
                                      window, scale, st);
  }
  if (dtype == 1)
    return D <= 128 ? tc::launch<128>(q, k, v, o, qo, kl, ls, B, Sq, Sk, H, Hk, D, causal,
                                      window, scale, st)
                    : tc::launch<256>(q, k, v, o, qo, kl, ls, B, Sq, Sk, H, Hk, D, causal,
                                      window, scale, st);
  return (int)cudaErrorInvalidValue;
}
