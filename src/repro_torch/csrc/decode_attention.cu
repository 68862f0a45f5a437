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
// floor is the live K/V bytes over 3.35 TB/s; at the serving shape (8
// slots, 3,698 live rows, 2 KV heads of 128) that is 1.1 us, so what
// sets the time is how many bytes are in flight at once and how soon
// the first arrive.
//
// Design. The TPU grid is (B*Hk, kv-blocks), sequential in kv, carrying
// m/l/acc in VMEM. At the serving shape B*Hk is only 16 (8 slots x 2 KV
// heads) against 132 SMs, so here the KV axis is split: one CTA of 4
// warps per (split, kv-head, batch) walks its chunk of rows in tiles of
// TR = 32 and writes partial (m, l, acc) for its g heads; a second small
// kernel combines the splits per head. Rows and whole splits at or past
// lengths[b] are never read, so the bytes moved follow the live
// context, not the cache size. A sequence with length 0 gets zeros
// (acc / max(l, 1e-30) with l = 0), never NaN. Masked scores are
// NEG_INF = -1e30 as in `_decode_kernel`; no fast-math exp. On request
// the combine pass also writes the output unrounded in fp32 and each
// head's log-sum-exp (-inf for a sequence with no live row), so that the
// partial outputs of one sequence's row ranges, held on several cards
// (the flash-decode cache layout), can be combined exactly.
//   - Loads: tiles stay in the storage type in shared memory and move
//     with 16-byte cp.async (8 bf16 or 4 fp32 a thread, 16 threads a
//     256-byte row) into a ring of NSTAGE = 4 tiles (3 for fp32 rows of
//     256, below); all but the last are issued before the first is
//     consumed, and each consumed tile issues the next. At the serving shape a split holds 2 tiles, so all of a
//     CTA's bytes are in flight at once. Rows past the split's end are
//     zero-filled, never read. A row that is not a multiple of 16 bytes
//     (or a base that is not 16-byte aligned) loads element by element
//     into rows zero-padded to the next 16 bytes: the same body
//     otherwise.
//   - Scores: warp-cooperative. The lanes of a row split it into
//     16-byte chunks; each lane holds its chunk of all g query heads in
//     registers (in the storage type), and a butterfly shuffle sums the
//     chunks of each head. A thread scores its 4 (bf16) or 8 (fp32)
//     rows of a tile together, 4 heads at a time, so the shuffle chains
//     of 16 or 32 sums interleave instead of waiting on one another.
//   - Head dims. The body is instantiated for two classes, DM = 128
//     (head_dim <= 128) and DM = 256 (head_dim 129 .. 256: gemma3 and
//     RecurrentGemma). A row of DM elements is LPR = min(32, DM / EPC)
//     lanes wide, and a lane takes CPL = DM / EPC / LPR chunks of it:
//     at DM = 128 16 lanes (bf16) or 32 (fp32) of one chunk, as above;
//     at DM = 256 32 lanes of one chunk (bf16) or of two (fp32). At
//     DM = 256 the query chunks stay in shared memory and are read as
//     each head's scores are summed: g = 16 rows of two chunks a lane
//     would take 128 registers in fp32. An fp32 tile of 32 rows of 256
//     is 32 KB a stage for K and V, so that instantiation keeps a ring
//     of 3 stages (about 210 KB of shared memory; 4 would pass the
//     227 KB a CTA may take). The score sums of a lane's chunks are
//     taken chunk by chunk, in the order of the columns.
//   - Online softmax: one warp per head, one lane per row of the tile.
//   - P V: each thread owns one 16-byte chunk of d-columns (8 or 4 fp32
//     accumulators) for up to 4 heads and walks the tile's rows.
//   - The combine stages each head's split maxima and sums in shared
//     memory, so its loop over the splits waits only on acc's loads.
// What bounds it now is latency: a CTA of 4 warps spends about 3.5 us a
// tile at the serving shape (tools/attention_sweep.py).
//
// Paged layout. One kernel body serves both layouts: a row-address
// functor maps (b, pos) to its row in the cache or the pool, and
// nothing else differs. The paged functor first reads the page numbers
// of the CTA's rows into shared memory, one table entry a page, and
// never an entry at or past lengths[b] (those pages may name the null
// block 0 or repeat a block); the tiles then follow the table without
// gathering pages into a contiguous copy. With the same split
// boundaries as the slotted wrapper every live row goes through the
// same fp32 operations in the same order, so a paged run's tokens equal
// a slotted run's bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TR = 32;      // KV rows per shared-memory tile (one warp wide)
constexpr int SP = TR + 1;  // stride of a head's scores: heads on other banks
constexpr int NT = 128;     // threads per CTA
constexpr int GMAX = 16;    // largest g = H / Hk taken
constexpr int DMAX = 256;   // largest head_dim taken
constexpr float NEG_INF = -1e30f;

// tiles of the ring: 4, or 3 where a row of DM elements passes 512 bytes
// (fp32 at DM = 256), so that the ring fits a CTA's shared memory
template <typename T, int DM> __host__ __device__ constexpr int nstage() {
  return DM * (int)sizeof(T) > 512 ? 3 : 4;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// a 16-byte chunk of the storage type, widened to fp32; N elements a chunk
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(const uint4& c, float* f) {
    f[0] = __uint_as_float(c.x);
    f[1] = __uint_as_float(c.y);
    f[2] = __uint_as_float(c.z);
    f[3] = __uint_as_float(c.w);
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void widen(const uint4& c, float* f) {
    const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

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

// row index (in units of Hk*D elements) of sequence b's position pos;
// prepare() runs once a CTA, before any row() of rows [s_lo, s_hi);
// pages() is the shared-memory entries prepare() needs for a split
struct SlottedRows {
  int S;
  int pages(int) const { return 0; }
  __device__ __forceinline__ void prepare(int*, int, int, int) const {}
  __device__ __forceinline__ size_t row(const int*, int b, int, int pos) const {
    return (size_t)b * S + pos;
  }
};
struct PagedRows {
  const int* tables;   // (B, nb) physical block per page
  int nb, bs;
  int pages(int chunk) const { return (chunk + bs - 1) / bs + 1; }
  // the physical blocks of the pages of rows [s_lo, s_hi), one entry a page
  __device__ __forceinline__ void prepare(int* sPage, int b, int s_lo, int s_hi) const {
    const int p0 = s_lo / bs, p1 = (s_hi - 1) / bs;
    for (int p = p0 + (int)threadIdx.x; p <= p1; p += NT) sPage[p - p0] = tables[b * nb + p];
  }
  __device__ __forceinline__ size_t row(const int* sPage, int, int s_lo, int pos) const {
    return (size_t)sPage[pos / bs - s_lo / bs] * bs + pos % bs;
  }
};

size_t smem_bytes(int D, int elem, int nst, int pages) {
  const int ds = (D * elem + 15) / 16 * 16;   // a padded row, bytes
  return (size_t)(nst * 2 * TR + GMAX) * ds + sizeof(float) * (GMAX * SP + 3 * GMAX) +
         sizeof(int) * pages;
}

// partials: pm/pl (B, Hk, nsplit, g), pacc (B, Hk, nsplit, g, D), fp32;
// S is the rows a sequence can address (the cache length, or nb * bs);
// DM is the head-dim class (128 or 256), D <= DM
template <typename T, typename Rows, int DM>
__global__ void __launch_bounds__(NT)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int* __restrict__ lengths,
                      float* __restrict__ pm, float* __restrict__ pl,
                      float* __restrict__ pacc, Rows rows, int S, int H, int Hk, int D,
                      int chunk, float scale, int vec) {
  constexpr int NSTAGE = nstage<T, DM>();
  constexpr int EPC = Chunk<T>::N;                 // elements a 16-byte chunk
  constexpr int LPR = DM / EPC < 32 ? DM / EPC : 32;   // lanes scoring one row
  constexpr int CPL = DM / EPC / LPR;              // chunks a lane scores
  constexpr int RI = TR * LPR / NT;                // rows a thread scores a tile
  constexpr bool QREG = DM <= 128;                 // query chunks in registers
  static_assert(CPL * LPR * EPC == DM && RI * NT == TR * LPR, "score mapping");
  constexpr int HPT = GMAX * DM / EPC / NT > 0 ? GMAX * DM / EPC / NT : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DS = (D + EPC - 1) / EPC * EPC;        // padded row, elements
  const int CPR = DS / EPC;                        // 16-byte chunks a row
  T* sKV = reinterpret_cast<T*>(smem_raw);         // NSTAGE x {K [TR][DS], V [TR][DS]}
  T* sQ = sKV + NSTAGE * 2 * TR * DS;              // [GMAX][DS]
  float* sS = reinterpret_cast<float*>(sQ + GMAX * DS);   // [GMAX][SP]
  float* sM = sS + GMAX * SP;
  float* sL = sM + GMAX;
  float* sC = sL + GMAX;
  int* sPage = reinterpret_cast<int*>(sC + GMAX);

  const int g = H / Hk;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int len = min(max(lengths[b], 0), S);
  const int s_lo = split * chunk;
  const int s_hi = min(s_lo + chunk, len);
  const size_t part = ((size_t)b * Hk + kvh) * nsplit + split;

  // P V mapping: thread (hs, cv) owns chunk cv of heads hs, hs + nhs, ...
  const int nhs = NT / CPR;
  const int cv = tid % CPR, hs = tid / CPR;
  const bool pv_thread = hs < nhs;

  if (s_lo >= s_hi) {                     // dead split: empty partials
    if (tid < g) {
      pm[part * g + tid] = NEG_INF;
      pl[part * g + tid] = 0.f;
    }
    for (int i = tid; i < g * D; i += NT) pacc[part * g * D + i] = 0.f;
    return;
  }

  rows.prepare(sPage, b, s_lo, s_hi);
  if (DS > D)                             // padding columns stay zero
    for (int i = tid; i < (NSTAGE * 2 * TR + GMAX) * (DS - D); i += NT)
      sKV[(i / (DS - D)) * DS + D + i % (DS - D)] = from_f<T>(0.f);
  if (tid < g) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }
  // the g query rows of this KV head: contiguous, g * D elements
  const T* qrow = q + ((size_t)b * H + kvh * g) * D;
  if (vec) {
    for (int i = tid; i < g * CPR; i += NT)
      cp_async16(sQ + i * EPC, qrow + i * EPC, true);
  } else {
    for (int i = tid; i < g * D; i += NT) sQ[(i / D) * DS + i % D] = qrow[i];
  }
  __syncthreads();                        // sPage; the scalar path's sQ

  const int ntiles = (s_hi - s_lo + TR - 1) / TR;
  const T* kbase = kc + (size_t)kvh * D;
  const T* vbase = vc + (size_t)kvh * D;
  auto issue = [&](int t) {               // tile t into stage t % NSTAGE
    T* sK = sKV + (t % NSTAGE) * 2 * TR * DS;
    T* sV = sK + TR * DS;
    const int t0 = s_lo + t * TR;
    if (vec) {
      for (int i = tid; i < TR * CPR; i += NT) {
        const int r = i / CPR, c = i % CPR, pos = t0 + r;
        const bool ok = pos < s_hi;
        const size_t off = ok ? rows.row(sPage, b, s_lo, pos) * Hk * D + c * EPC : 0;
        cp_async16(sK + r * DS + c * EPC, kbase + off, ok);
        cp_async16(sV + r * DS + c * EPC, vbase + off, ok);
      }
    } else {
      for (int i = tid; i < TR * D; i += NT) {
        const int r = i / D, d = i % D, pos = t0 + r;
        T kx = from_f<T>(0.f), vx = from_f<T>(0.f);
        if (pos < s_hi) {
          const size_t off = rows.row(sPage, b, s_lo, pos) * Hk * D + d;
          kx = kbase[off];
          vx = vbase[off];
        }
        sK[r * DS + d] = kx;
        sV[r * DS + d] = vx;
      }
    }
  };
#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) {
    if (t < ntiles) issue(t);
    cp_commit();
  }

  // score mapping: lane cs of a row's LPR holds chunks cs, cs + LPR, ...;
  // this thread scores rows r0, r0 + NT / LPR, ...
  const int cs = lane % LPR, r0 = tid / LPR;
  uint4 qr[QREG ? GMAX : 1];              // this lane's chunk of every head
  float acc[HPT][EPC];
#pragma unroll
  for (int i = 0; i < HPT; ++i)
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();                      // tile t - 1 consumed: its stage is free
    if (t + NSTAGE - 1 < ntiles) issue(t + NSTAGE - 1);
    cp_commit();
    cp_wait<NSTAGE - 1>();                // tile t (and q) have landed
    __syncthreads();
    if (QREG && t == 0)
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi)
        qr[QREG ? gi : 0] = (gi < g && cs < CPR)
                                ? *reinterpret_cast<const uint4*>(sQ + gi * DS + cs * EPC)
                                : make_uint4(0, 0, 0, 0);
    const T* sK = sKV + (t % NSTAGE) * 2 * TR * DS;
    const T* sV = sK + TR * DS;
    const int t0 = s_lo + t * TR;
    const int live = min(TR, s_hi - t0);

    // scores: LPR lanes a row, each lane CPL chunks; for 4 heads at a
    // time every row's shuffle sums run interleaved
    float kf[CPL][RI][EPC];
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int k = 0; k < RI; ++k) {
        const int ch = cs + c * LPR;
        if (ch < CPR)
          Chunk<T>::widen(
              *reinterpret_cast<const uint4*>(sK + (r0 + k * (NT / LPR)) * DS + ch * EPC),
              kf[c][k]);
        else
#pragma unroll
          for (int e = 0; e < EPC; ++e) kf[c][k][e] = 0.f;
      }
#pragma unroll
    for (int g0 = 0; g0 < GMAX; g0 += 4) {
      if (g0 >= g) break;
      float sc[RI][4];
#pragma unroll
      for (int k = 0; k < RI; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[k][j] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = cs + c * LPR;
        float qf[4][EPC];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint4 qc = make_uint4(0, 0, 0, 0);
          if (QREG)
            qc = qr[QREG ? g0 + j : 0];
          else if (g0 + j < g && ch < CPR)
            qc = *reinterpret_cast<const uint4*>(sQ + (g0 + j) * DS + ch * EPC);
          Chunk<T>::widen(qc, qf[j]);
        }
#pragma unroll
        for (int k = 0; k < RI; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < EPC; ++e)
              sc[k][j] = fmaf(qf[j][e], kf[c][k][e], sc[k][j]);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int k = 0; k < RI; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[k][j] += __shfl_xor_sync(0xffffffffu, sc[k][j], off);
      if (cs == 0)
#pragma unroll
        for (int k = 0; k < RI; ++k) {
          const int r = r0 + k * (NT / LPR);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (g0 + j < g) sS[(g0 + j) * SP + r] = r < live ? sc[k][j] * scale : NEG_INF;
        }
    }
    __syncthreads();
    // online softmax: one warp per head, one lane per row
    for (int gi = warp; gi < g; gi += NT / 32) {
      const float m_prev = sM[gi];
      const float sv = sS[gi * SP + lane];
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(sv - m_new);
      sS[gi * SP + lane] = p;
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
    // acc = acc * corr + P V over the tile's live rows
    if (pv_thread) {
#pragma unroll
      for (int i = 0; i < HPT; ++i) {
        const int gi = hs + nhs * i;
        if (gi < g)
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[i][e] *= sC[gi];
      }
      // all TR rows: past `live` p is exactly 0 and V zero-filled
#pragma unroll 8
      for (int r = 0; r < TR; ++r) {
        float vf[EPC];
        Chunk<T>::widen(*reinterpret_cast<const uint4*>(sV + r * DS + cv * EPC), vf);
#pragma unroll
        for (int i = 0; i < HPT; ++i) {
          const int gi = hs + nhs * i;
          if (gi < g) {
            const float p = sS[gi * SP + r];
#pragma unroll
            for (int e = 0; e < EPC; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e]);
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();
  if (tid < g) {
    pm[part * g + tid] = sM[tid];
    pl[part * g + tid] = sL[tid];
  }
  if (pv_thread) {
#pragma unroll
    for (int i = 0; i < HPT; ++i) {
      const int gi = hs + nhs * i;
      if (gi >= g) continue;
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        const int d = cv * EPC + e;
        if (d < D) pacc[(part * g + gi) * D + d] = acc[i][e];
      }
    }
  }
}

// one CTA per (query head, batch); thread d owns one output column. The
// splits' m and l are staged in shared memory by one pass of loads, so
// each thread's sums over the splits wait on the pacc loads alone; the
// order of the sums is the splits' order. With o32 the output is written
// there in fp32, unrounded, and o is not written; with lse, each head's
// log-sum-exp m + log(l) of its scaled scores (-inf where no row is
// live): what a combine of partial outputs over row ranges reads.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                                      const float* __restrict__ pacc, T* __restrict__ o,
                                      float* __restrict__ o32, float* __restrict__ lse, int H,
                                      int Hk, int D, int nsplit) {
  extern __shared__ float sML[];          // [nsplit] m, then [nsplit] l
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int g = H / Hk;
  const int kvh = h / g, gi = h % g;
  const size_t base = ((size_t)b * Hk + kvh) * nsplit;
  for (int s = d; s < nsplit; s += blockDim.x) {
    sML[s] = pm[(base + s) * g + gi];
    sML[nsplit + s] = pl[(base + s) * g + gi];
  }
  __syncthreads();
  float m = NEG_INF;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, sML[s]);
  float l = 0.f, acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(sML[s] - m);
    l = fmaf(sML[nsplit + s], w, l);
    acc = fmaf(pacc[((base + s) * g + gi) * D + d], w, acc);
  }
  const size_t row = (size_t)b * H + h;
  if (d < D) {
    const float out = acc / fmaxf(l, 1e-30f);
    if (o32)
      o32[row * D + d] = out;
    else
      o[row * D + d] = from_f<T>(out);
  }
  if (lse && d == 0) lse[row] = l > 0.f ? m + logf(l) : __int_as_float(0xff800000);  // -inf
}

template <typename T, typename Rows, int DM>
int launch(const void* q, const void* kc, const void* vc, const int* lengths, float* pm,
           float* pl, float* pacc, void* o, float* o32, float* lse, Rows rows, int B, int S,
           int H, int Hk, int D, int chunk, float scale, cudaStream_t stream) {
  const int nsplit = (S + chunk - 1) / chunk;
  const size_t smem = smem_bytes(D, (int)sizeof(T), nstage<T, DM>(), rows.pages(chunk));
  // the default limit, raised once as needed: one value per instantiation
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(decode_partial_kernel<T, Rows, DM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const bool aligned = ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(kc) |
                         reinterpret_cast<size_t>(vc)) % 16) == 0;
  const int vec = (D * (int)sizeof(T)) % 16 == 0 && aligned;
  dim3 grid(nsplit, Hk, B);
  decode_partial_kernel<T, Rows, DM><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), lengths,
      pm, pl, pacc, rows, S, H, Hk, D, chunk, scale, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<dim3(H, B), D, 2 * sizeof(float) * nsplit, stream>>>(
      pm, pl, pacc, static_cast<T*>(o), o32, lse, H, Hk, D, nsplit);
  return (int)cudaGetLastError();
}

template <typename Rows>
int dispatch(const void* q, const void* kc, const void* vc, const void* lengths, void* pm,
             void* pl, void* pacc, void* o, void* o32, void* lse, Rows rows, int B, int S,
             int H, int Hk, int D, int chunk, float scale, int dtype, void* stream) {
  if (Hk <= 0 || H % Hk != 0 || H / Hk > GMAX || D <= 0 || D > DMAX || S <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* fm = static_cast<float*>(pm);
  float* fl = static_cast<float*>(pl);
  float* fa = static_cast<float*>(pacc);
  float* fo = static_cast<float*>(o32);
  float* fs = static_cast<float*>(lse);
  const bool wide = D > 128;
  if (dtype == 0)
    return (wide ? launch<float, Rows, 256> : launch<float, Rows, 128>)(
        q, kc, vc, lens, fm, fl, fa, o, fo, fs, rows, B, S, H, Hk, D, chunk, scale, st);
  if (dtype == 1)
    return (wide ? launch<__nv_bfloat16, Rows, 256> : launch<__nv_bfloat16, Rows, 128>)(
        q, kc, vc, lens, fm, fl, fa, o, fo, fs, rows, B, S, H, Hk, D, chunk, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B,H,D), caches (B,S,Hk,D), lengths (B,) int32, o (B,H,D); q, caches
// and o share one dtype (0 = float32, 1 = bfloat16). The fp32 scratch
// pm/pl hold B*Hk*nsplit*g floats and pacc that times D, with
// nsplit = ceil(S / chunk). o32 (B,H,D) and lse (B,H), fp32, may be null:
// with o32 the output goes there unrounded instead of to o; with lse each
// head's log-sum-exp is written too. Returns a cudaError_t code (0 = ok).
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                                    const void* lengths, void* pm, void* pl, void* pacc,
                                    void* o, void* o32, void* lse, int B, int S, int H, int Hk,
                                    int D, int chunk, float scale, int dtype, void* stream) {
  return dispatch(q, kc, vc, lengths, pm, pl, pacc, o, o32, lse, SlottedRows{S}, B, S, H, Hk,
                  D, chunk, scale, dtype, stream);
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
  return dispatch(q, kp, vp, lengths, pm, pl, pacc, o, nullptr, nullptr, rows, B, nb * bs, H,
                  Hk, D, chunk, scale, dtype, stream);
}
