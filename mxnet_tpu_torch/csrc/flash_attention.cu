// Flash-attention forward and backward, for sm_90a.
//
// Replaces the TPU kernels _fwd_kernel_single and _fwd_kernel
// (mxnet_tpu/ops/pallas_attention.py, launched by pallas_flash_attention and
// pallas_flash_attention_bshd).  For one (batch * head) row of q (Tq, D) and
// k, v (Tk, D) it computes
//
//     s = q k^T * scale,  masked to -1e30 where a key is not visible
//     o = softmax(s) v,   lse = logsumexp(s)   (per query row, fp32)
//
// with the masks of the TPU kernels: keys at or past the row's valid length
// (kv_lens[b], clamped to Tk), keys above the diagonal when causal (a query
// row r sees the keys c <= r), and keys of another segment (q_seg[b, r] !=
// kv_seg[b, c]).  A row that sees no key gives o = 0 and lse = 0.
//
// One design covers both TPU kernels.  The single-pass kernel takes the whole
// K axis as one VMEM block, the streaming kernel walks it in blocks with an
// online softmax.  On Hopper a block has 227 KB of shared memory and a
// thread at most 255 registers, so the natural K tile is 64 keys: a block
// holds one 64-row Q tile and loops over 64-key tiles of K and V staged in
// shared memory, keeping the running row max, the normaliser and the output
// accumulator in fp32 registers.  The TPU's single pass is this loop with
// one tile.  K tiles wholly past the valid length, or wholly above the
// diagonal, are not visited; the tile that straddles the edge is masked
// element by element.  The rows and keys past Tq and Tk are masked here, so
// the caller pads only D (to 64 or 128).
//
// bf16 runs on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
// accumulate): a 128-thread block of four warps, each warp 16 query rows.
// The Q fragments stay in registers for the whole loop; K is staged row
// major, V transposed, each row padded by 8 elements so that the fragment
// reads are free of bank conflicts.  The score fragments become the A
// fragments of the P.V product in registers, with P rounded to bf16 first
// and the normaliser summed from the unrounded fp32 P, as the TPU kernels
// round it.  f32 has no tensor-core path with TF32 off, so it runs scalar
// fp32 FMAs: a 256-thread block computes the 64 x 64 score tile into shared
// memory (4 x 4 per thread), four threads a row take the online softmax,
// and each thread accumulates a 4 x (D/16) slice of the output.
//
// What bounds it at BERT-base (B 24, H 12, T 512, D 64, bf16): bytes,
// narrowly.  4 B H T^2 D = 19.3 GFLOP a layer is 19.5 us at 989 TFLOP/s; q,
// k, v and o are 75.5 MB, 22.5 us at 3.35 TB/s.  With bench.py's valid
// lengths the keys past them are skipped: 14.5 GFLOP (14.7 us) against 66 MB
// (19.8 us).  This first design is simple, not fast: no cp.async or TMA
// pipelining of the K and V tiles, no wgmma, and the tiles are synchronised
// each step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;   // query rows of a block
constexpr int BK = 64;   // keys of a K tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* lens;   // (B,) valid key lengths, or null
  const int* qseg;   // (B, Tq) segment ids, or null
  const int* kseg;   // (B, Tk) segment ids, or null when qseg is
  int H, Tq, Tk, n_qtiles;
  float scale;
  int causal;
};

// the valid key length of batch row b, clamped to [0, Tk]
__device__ __forceinline__ int valid_keys(const Params& p, int b) {
  if (p.lens == nullptr) return p.Tk;
  return min(max(p.lens[b], 0), p.Tk);
}

// how many K tiles the Q tile starting at q0 visits
__device__ __forceinline__ int key_tiles(const Params& p, int kvlen, int q0) {
  int end = kvlen;
  if (p.causal) end = min(end, min(q0 + BQ, p.Tq));
  return end > 0 ? (end + BK - 1) / BK : 0;
}

// whether no element of the (q0, k0) tile is masked
__device__ __forceinline__ bool tile_unmasked(const Params& p, int kvlen,
                                              int q0, int k0) {
  return k0 + BK <= kvlen && (!p.causal || q0 >= k0 + BK - 1) &&
         p.qseg == nullptr && q0 + BQ <= p.Tq;
}

__device__ __forceinline__ bool visible(const Params& p, int b, int kvlen,
                                        int row, int col) {
  if (row >= p.Tq || col >= kvlen) return false;
  if (p.causal && row < col) return false;
  if (p.qseg != nullptr &&
      p.qseg[(size_t)b * p.Tq + row] != p.kseg[(size_t)b * p.Tk + col])
    return false;
  return true;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
constexpr size_t bf16_smem_bytes() {
  return ((size_t)BQ * (D + 8) + (size_t)BK * (D + 8) +
          (size_t)D * (BK + 8)) * sizeof(bf16);
}

// bf16 on the tensor cores.  Fragment layouts of m16n8k16 (g = lane / 4,
// t = lane % 4): A holds rows g and g + 8, columns 2t, 2t+1, 2t+8, 2t+9;
// B holds column g, rows 2t, 2t+1, 2t+8, 2t+9; C holds rows g and g + 8,
// columns 2t and 2t + 1.
template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16(Params p) {
  constexpr int LDS = D + 8;    // row stride of the Q and K tiles
  constexpr int LDV = BK + 8;   // row stride of the transposed V tile
  constexpr int DC = D / 8;     // 16-byte chunks in a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * LDS;
  bf16* sVt = sK + BK * LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / p.n_qtiles;
  const int q0 = (blockIdx.x % p.n_qtiles) * BQ;
  const int b = bh / p.H;
  const bf16* q = static_cast<const bf16*>(p.q) + (size_t)bh * p.Tq * D;
  const bf16* k = static_cast<const bf16*>(p.k) + (size_t)bh * p.Tk * D;
  const bf16* v = static_cast<const bf16*>(p.v) + (size_t)bh * p.Tk * D;

  for (int i = tid; i < BQ * DC; i += 128) {
    const int r = i / DC, c = (i % DC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.Tq)
      val = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(sQ + r * LDS + c) = val;
  }
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* base = sQ + (warp * 16 + g) * LDS + kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 8);
  }

  const int row0 = q0 + warp * 16 + g;     // this thread's rows: row0, +8
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};                 // this thread's share of the sum
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int kvlen = valid_keys(p, b);
  const int n_tiles = key_tiles(p, kvlen, q0);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    __syncthreads();                       // the last tile's reads are done
    for (int i = tid; i < BK * DC; i += 128) {
      // K: a row's 16-byte chunks on neighbouring threads
      const int r = i / DC, c = (i % DC) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < p.Tk)
        kv = *reinterpret_cast<const uint4*>(k + (size_t)(k0 + r) * D + c);
      *reinterpret_cast<uint4*>(sK + r * LDS + c) = kv;
      // V, transposed: neighbouring threads take neighbouring keys, so the
      // 2-byte stores of one column land in consecutive words
      const int rv = i % BK, cv = (i / BK) * 8;
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + rv < p.Tk)
        vv = *reinterpret_cast<const uint4*>(v + (size_t)(k0 + rv) * D + cv);
      const bf16* vh = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(cv + j) * LDV + rv] = vh[j];
    }
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const bf16* kb = sK + (nt * 8 + g) * LDS + kk * 16 + 2 * t;
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    const bool full = tile_unmasked(p, kvlen, q0, k0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * p.scale;
        if (!full && !visible(p, b, kvlen, row0 + (i >> 1) * 8,
                              k0 + nt * 8 + 2 * t + (i & 1)))
          x = kNegInf;
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
    // p = exp(s - m); a masked entry is 0 also in a row that sees nothing
    // yet, where m is still -1e30
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[nt][i];
        const float pv = x == kNegInf ? 0.f : expf(x - m[i >> 1]);
        l[i >> 1] += pv;
        s[nt][i] = pv;
      }
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const bf16* vb = sVt + (dt * 8 + g) * LDV + kk * 16 + 2 * t;
        mma_bf16(acc[dt], pf, *reinterpret_cast<const uint32_t*>(vb),
                 *reinterpret_cast<const uint32_t*>(vb + 8));
      }
    }
  }

  bf16* o = static_cast<bf16*>(p.o) + (size_t)bh * p.Tq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = row0 + h * 8;
    if (row >= p.Tq) continue;
    const float den = l[h] > 0.f ? l[h] : 1.f;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(o + (size_t)row * D + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * h] / den, acc[dt][2 * h + 1] / den);
    }
    if (t == 0)
      p.lse[(size_t)bh * p.Tq + row] =
          l[h] > 0.f ? m[h] + logf(l[h]) : 0.f;
  }
}

template <int D>
constexpr size_t f32_smem_bytes() {
  return ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
          (size_t)BQ * (BK + 1) + 2 * BQ) * sizeof(float);
}

// f32 with scalar FMAs.  Thread roles: the score tile and the output tile
// by (tid / 16, tid % 16): rows 4 (tid / 16) .. + 3, columns tid % 16 + 16 j;
// the softmax by (tid / 4, tid % 4): one row, 16 of its keys.
template <int D>
__global__ void __launch_bounds__(256) flash_fwd_f32(Params p) {
  constexpr int LQ = D + 1;      // row stride of the Q and K tiles
  constexpr int LS = BK + 1;     // row stride of the score tile
  constexpr int DJ = D / 16;     // output columns a thread holds
  extern __shared__ __align__(16) float smf[];
  float* sQ = smf;
  float* sK = sQ + BQ * LQ;
  float* sV = sK + BK * LQ;
  float* sS = sV + BK * D;
  float* sCorr = sS + BQ * LS;
  float* sL = sCorr + BQ;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / p.n_qtiles;
  const int q0 = (blockIdx.x % p.n_qtiles) * BQ;
  const int b = bh / p.H;
  const float* q = static_cast<const float*>(p.q) + (size_t)bh * p.Tq * D;
  const float* k = static_cast<const float*>(p.k) + (size_t)bh * p.Tk * D;
  const float* v = static_cast<const float*>(p.v) + (size_t)bh * p.Tk * D;

  for (int i = tid; i < BQ * D; i += 256) {
    const int r = i / D, c = i % D;
    sQ[r * LQ + c] = q0 + r < p.Tq ? q[(size_t)(q0 + r) * D + c] : 0.f;
  }
  const int tr = tid / 16, tc = tid % 16;    // score and output tiles
  const int sr = tid / 4, sp = tid % 4;      // softmax: row, quarter
  float m_run = kNegInf, l_part = 0.f;
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int kvlen = valid_keys(p, b);
  const int n_tiles = key_tiles(p, kvlen, q0);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    __syncthreads();
    for (int i = tid; i < BK * D; i += 256) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.Tk;
      sK[r * LQ + c] = in ? k[(size_t)(k0 + r) * D + c] : 0.f;
      sV[r * D + c] = in ? v[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(tr * 4 + i) * LQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sK[(tc + 16 * j) * LQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qa[i] * kb[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sS[(tr * 4 + i) * LS + tc + 16 * j] = sc[i][j];
    __syncthreads();

    const bool full = tile_unmasked(p, kvlen, q0, k0);
    float x[16];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float val = sS[sr * LS + sp * 16 + c] * p.scale;
      if (!full && !visible(p, b, kvlen, q0 + sr, k0 + sp * 16 + c))
        val = kNegInf;
      x[c] = val;
      mx = fmaxf(mx, val);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    m_run = m_new;
    l_part *= corr;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float pv = x[c] == kNegInf ? 0.f : expf(x[c] - m_new);
      l_part += pv;
      sS[sr * LS + sp * 16 + c] = pv;
    }
    if (sp == 0) sCorr[sr] = corr;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = sCorr[tr * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= cr;
    }
    for (int c = 0; c < BK; ++c) {
      float pa[4], vb[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sS[(tr * 4 + i) * LS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vb[j] = sV[c * D + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += pa[i] * vb[j];
    }
  }

  l_part += __shfl_xor_sync(0xffffffffu, l_part, 1);
  l_part += __shfl_xor_sync(0xffffffffu, l_part, 2);
  __syncthreads();
  if (sp == 0) sL[sr] = l_part;
  if (sp == 0 && q0 + sr < p.Tq)
    p.lse[(size_t)bh * p.Tq + q0 + sr] =
        l_part > 0.f ? m_run + logf(l_part) : 0.f;
  __syncthreads();
  float* o = static_cast<float*>(p.o) + (size_t)bh * p.Tq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (q0 + r >= p.Tq) continue;
    const float den = sL[r] > 0.f ? sL[r] : 1.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      o[(size_t)(q0 + r) * D + tc + 16 * j] = acc[i][j] / den;
  }
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int BH, int threads, size_t smem,
           cudaStream_t s) {
  // above 48 KB only as dynamic shared memory, after this opt-in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((long long)BH * p.n_qtiles), threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
//
// Replaces the TPU kernels _dqkv_single_kernel, _dqkv_fused_kernel and the
// pair _dq_kernel + _dkv_kernel (mxnet_tpu/ops/pallas_attention.py, launched
// by pallas_flash_attention_bwd).  From q, k, v, the forward's o and lse and
// the cotangent dO, with the forward's masks:
//
//     p = exp(s * scale - lse)   (0 where masked),  delta = rowsum(dO * O)
//     dp = dO v^T,  ds = p (dp - delta) * scale
//     dv = bf16(p)^T dO,  dq = bf16(ds) k,  dk = bf16(ds)^T q
//
// with every product summed in fp32 and p and ds rounded to the operands'
// dtype where the TPU kernels round them.  One design covers the three TPU
// kernels: a Hopper block holds 64-row tiles, so it always streams, and the
// TPU's single-block kernels are its one-tile case.  It is the TPU's split
// form, deterministic (no atomics): flash_bwd_q, a block per 64-query tile
// streaming the K tiles, and flash_bwd_kv, a block per 64-key tile
// streaming the Q tiles, both recomputing p from lse; flash_bwd_delta
// computes delta first.  Keys past a row's valid length get dk = dv = 0.
//
// What bounds it at BERT-base (B 24, H 12, T 512, D 64, bf16, bench.py's
// valid lengths): bytes, narrowly.  q, o, dO and dq whole and k, v, dk and
// dv up to the valid lengths are 137 MB, 41 us at 3.35 TB/s; the five
// products the visible pairs need are 36 GFLOP, 36 us at 989 TFLOP/s.  This
// first design recomputes s and dp in both kernels (seven products), stages
// the operands it needs transposed a second time in shared memory, and does
// not pipeline its tile loads.

struct BwdParams : Params {
  const void* dout;    // dO: BH x Tq x D
  const float* delta;  // rowsum(dO * O): BH x Tq
  void* dq;
  void* dk;
  void* dv;
  int n_ktiles;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

// delta[r] = sum_d dO[r, d] * O[r, d] in fp32, one warp a row
template <typename T>
__global__ void __launch_bounds__(128)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, long long rows, int D) {
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s += to_float(o[row * D + d]) * to_float(dout[row * D + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// the first Q tile that sees any key of the K tile at k0 (causal: the rows
// r >= k0; BQ == BK, so that is tile k0 / BQ)
__device__ __forceinline__ int first_query_tile(const Params& p, int k0) {
  return p.causal ? k0 / BQ : 0;
}

// 16-byte chunk c of row r of a (rows x D) tile into row-major shared
// memory with row stride LDS, zeros past `rows_valid`
template <int D, int LDS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int r0, int rows_valid, int tid,
                                           int nthreads) {
  constexpr int DC = D / 8;
  for (int i = tid; i < 64 * DC; i += nthreads) {
    const int r = i / DC, c = (i % DC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows_valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

// the same 64-row tile stored transposed, D rows of 64 (+ 8 padding),
// neighbouring threads on neighbouring source rows
template <int D, int LDT>
__device__ __forceinline__ void stage_cols(bf16* dst, const bf16* src,
                                           int r0, int rows_valid, int tid,
                                           int nthreads) {
  for (int i = tid; i < 64 * (D / 8); i += nthreads) {
    const int r = i % 64, c = (i / 64) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows_valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    const bf16* h = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * LDT + r] = h[j];
  }
}

// A fragment (16 x 16) of rows row0.. of a row-major shared tile, columns
// 16 kk ..
template <int LDS>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int row0, int kk, int g, int t) {
  const bf16* base = tile + (row0 + g) * LDS + kk * 16 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(base);
  a[1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
  a[2] = *reinterpret_cast<const uint32_t*>(base + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 8);
}

// B fragment (16 x 8): column n of B is row n0 + g of a row-major shared
// tile, its k rows columns 16 kk + 2t ..
template <int LDS>
__device__ __forceinline__ void mma_b_rows(float (&c)[4],
                                           const uint32_t (&a)[4],
                                           const bf16* tile, int n0, int kk,
                                           int g, int t) {
  const bf16* b = tile + (n0 + g) * LDS + kk * 16 + 2 * t;
  mma_bf16(c, a, *reinterpret_cast<const uint32_t*>(b),
           *reinterpret_cast<const uint32_t*>(b + 8));
}

// the accumulators of n-tiles 2 kk and 2 kk + 1 (16 rows x 16 columns)
// rounded to bf16 as the A fragment of the next product
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

template <int D>
constexpr size_t bwd_kv_bf16_smem_bytes() {
  return (4 * (size_t)64 * (D + 8) + 2 * (size_t)D * (64 + 8)) *
             sizeof(bf16) + 2 * BQ * sizeof(float);
}

// dK and dV of one 64-key tile, bf16 on the tensor cores.  Four warps, each
// owns 16 keys and keeps their dK and dV rows in fp32 registers while the
// Q tiles stream past.  Per Q tile: S^T = K Q^T and dP^T = V dO^T (keys x
// queries, fp32 accumulators), P^T = exp(S^T * scale - lse) (0 where
// masked), dS^T = P^T (dP^T - delta) * scale, then dV += bf16(P^T) dO and
// dK += bf16(dS^T) Q with the accumulators turned into A fragments in
// registers.  Q and dO are staged row-major (B operands of the first two
// products) and transposed (B operands of the last two).
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_kv_bf16(BwdParams p) {
  constexpr int LDS = D + 8;
  constexpr int LDT = BQ + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BK * LDS;
  bf16* sQ = sV + BK * LDS;
  bf16* sdO = sQ + BQ * LDS;
  bf16* sQt = sdO + BQ * LDS;
  bf16* sdOt = sQt + D * LDT;
  float* sLse = reinterpret_cast<float*>(sdOt + D * LDT);
  float* sDelta = sLse + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / p.n_ktiles;
  const int k0 = (blockIdx.x % p.n_ktiles) * BK;
  const int b = bh / p.H;
  const bf16* q = static_cast<const bf16*>(p.q) + (size_t)bh * p.Tq * D;
  const bf16* k = static_cast<const bf16*>(p.k) + (size_t)bh * p.Tk * D;
  const bf16* v = static_cast<const bf16*>(p.v) + (size_t)bh * p.Tk * D;
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + (size_t)bh * p.Tq * D;
  const float* lse = p.lse + (size_t)bh * p.Tq;
  const float* delta = p.delta + (size_t)bh * p.Tq;

  stage_rows<D, LDS>(sK, k, k0, p.Tk, tid, 128);
  stage_rows<D, LDS>(sV, v, k0, p.Tk, tid, 128);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[dt][i] = dv[dt][i] = 0.f;

  const int kvlen = valid_keys(p, b);
  const int key0 = k0 + warp * 16 + g;     // this thread's keys: key0, +8
  // keys at or past the valid length see nothing: dK = dV = 0
  const int it_end = k0 < kvlen ? p.n_qtiles : 0;
  for (int it = first_query_tile(p, k0); it < it_end; ++it) {
    const int q0 = it * BQ;
    __syncthreads();                       // the last tile's reads are done
    stage_rows<D, LDS>(sQ, q, q0, p.Tq, tid, 128);
    stage_rows<D, LDS>(sdO, dout, q0, p.Tq, tid, 128);
    stage_cols<D, LDT>(sQt, q, q0, p.Tq, tid, 128);
    stage_cols<D, LDT>(sdOt, dout, q0, p.Tq, tid, 128);
    for (int i = tid; i < BQ; i += 128) {
      const bool in = q0 + i < p.Tq;
      sLse[i] = in ? lse[q0 + i] : 0.f;
      sDelta[i] = in ? delta[q0 + i] : 0.f;
    }
    __syncthreads();

    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kf[4], vf[4];
      load_a<LDS>(kf, sK, warp * 16, kk, g, t);
      load_a<LDS>(vf, sV, warp * 16, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        mma_b_rows<LDS>(s[nt], kf, sQ, nt * 8, kk, g, t);
        mma_b_rows<LDS>(dp[nt], vf, sdO, nt * 8, kk, g, t);
      }
    }

    // element (nt, i): key key0 + (i >> 1) * 8, query q0 + nt * 8 + 2t +
    // (i & 1)
    const bool full = tile_unmasked(p, kvlen, q0, k0);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = nt * 8 + 2 * t + (i & 1);
        float pv = 0.f;
        if (full || visible(p, b, kvlen, q0 + qc, key0 + (i >> 1) * 8))
          pv = expf(s[nt][i] * p.scale - sLse[qc]);
        dp[nt][i] = pv * (dp[nt][i] - sDelta[qc]) * p.scale;
        s[nt][i] = pv;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pf[4], dsf[4];
      acc_to_a(pf, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(dsf, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        mma_b_rows<LDT>(dv[dt], pf, sdOt, dt * 8, kk, g, t);
        mma_b_rows<LDT>(dk[dt], dsf, sQt, dt * 8, kk, g, t);
      }
    }
  }

  bf16* dkp = static_cast<bf16*>(p.dk) + (size_t)bh * p.Tk * D;
  bf16* dvp = static_cast<bf16*>(p.dv) + (size_t)bh * p.Tk * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + h * 8;
    if (key >= p.Tk) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const size_t at = (size_t)key * D + dt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkp + at) =
          pack_bf16(dk[dt][2 * h], dk[dt][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvp + at) =
          pack_bf16(dv[dt][2 * h], dv[dt][2 * h + 1]);
    }
  }
}

template <int D>
constexpr size_t bwd_q_bf16_smem_bytes() {
  return (4 * (size_t)64 * (D + 8) + (size_t)D * (64 + 8)) * sizeof(bf16);
}

// dQ of one 64-query tile, bf16 on the tensor cores.  Four warps, each owns
// 16 query rows and keeps their dQ rows in fp32 registers while the K tiles
// stream past.  Per K tile: S = Q K^T and dP = dO V^T, P = exp(S * scale -
// lse) (0 where masked), dS = P (dP - delta) * scale, dQ += bf16(dS) K.
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_q_bf16(BwdParams p) {
  constexpr int LDS = D + 8;
  constexpr int LDT = BK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + BQ * LDS;
  bf16* sK = sdO + BQ * LDS;
  bf16* sV = sK + BK * LDS;
  bf16* sKt = sV + BK * LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / p.n_qtiles;
  const int q0 = (blockIdx.x % p.n_qtiles) * BQ;
  const int b = bh / p.H;
  const bf16* q = static_cast<const bf16*>(p.q) + (size_t)bh * p.Tq * D;
  const bf16* k = static_cast<const bf16*>(p.k) + (size_t)bh * p.Tk * D;
  const bf16* v = static_cast<const bf16*>(p.v) + (size_t)bh * p.Tk * D;
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + (size_t)bh * p.Tq * D;

  stage_rows<D, LDS>(sQ, q, q0, p.Tq, tid, 128);
  stage_rows<D, LDS>(sdO, dout, q0, p.Tq, tid, 128);
  const int row0 = q0 + warp * 16 + g;     // this thread's rows: row0, +8
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    const bool in = row < p.Tq;
    lse_r[h] = in ? p.lse[(size_t)bh * p.Tq + row] : 0.f;
    dl_r[h] = in ? p.delta[(size_t)bh * p.Tq + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int kvlen = valid_keys(p, b);
  const int n_tiles = key_tiles(p, kvlen, q0);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    __syncthreads();
    stage_rows<D, LDS>(sK, k, k0, p.Tk, tid, 128);
    stage_rows<D, LDS>(sV, v, k0, p.Tk, tid, 128);
    stage_cols<D, LDT>(sKt, k, k0, p.Tk, tid, 128);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4], dof[4];
      load_a<LDS>(qf, sQ, warp * 16, kk, g, t);
      load_a<LDS>(dof, sdO, warp * 16, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        mma_b_rows<LDS>(s[nt], qf, sK, nt * 8, kk, g, t);
        mma_b_rows<LDS>(dp[nt], dof, sV, nt * 8, kk, g, t);
      }
    }
    const bool full = tile_unmasked(p, kvlen, q0, k0);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        float pv = 0.f;
        if (full || visible(p, b, kvlen, row0 + h * 8,
                            k0 + nt * 8 + 2 * t + (i & 1)))
          pv = expf(s[nt][i] * p.scale - lse_r[h]);
        dp[nt][i] = pv * (dp[nt][i] - dl_r[h]) * p.scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t dsf[4];
      acc_to_a(dsf, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        mma_b_rows<LDT>(acc[dt], dsf, sKt, dt * 8, kk, g, t);
    }
  }

  bf16* dq = static_cast<bf16*>(p.dq) + (size_t)bh * p.Tq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dq + (size_t)row * D + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * h], acc[dt][2 * h + 1]);
  }
}

// a 64-row tile of a float (rows x D) array into shared memory with row
// stride D + 1, zeros past `rows_valid`
template <int D>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               int r0, int rows_valid,
                                               int tid) {
  for (int i = tid; i < 64 * D; i += 256) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < rows_valid ? src[(size_t)(r0 + r) * D + c]
                                               : 0.f;
  }
}

template <int D>
constexpr size_t bwd_kv_f32_smem_bytes() {
  return (4 * (size_t)64 * (D + 1) + 2 * (size_t)64 * (64 + 1) + 2 * 64) *
         sizeof(float);
}

// dK and dV of one 64-key tile in f32 with scalar FMAs (256 threads).
// Thread roles: the 64 x 64 S^T tile and the dK/dV tile by (tid / 16,
// tid % 16): keys 4 (tid / 16) .. + 3, columns tid % 16 + 16 j.
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_kv_f32(BwdParams p) {
  constexpr int LQ = D + 1;
  constexpr int LS = BQ + 1;
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) float smf[];
  float* sK = smf;
  float* sV = sK + BK * LQ;
  float* sQ = sV + BK * LQ;
  float* sdO = sQ + BQ * LQ;
  float* sP = sdO + BQ * LQ;
  float* sDS = sP + BK * LS;
  float* sLse = sDS + BK * LS;
  float* sDelta = sLse + BQ;

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int bh = blockIdx.x / p.n_ktiles;
  const int k0 = (blockIdx.x % p.n_ktiles) * BK;
  const int b = bh / p.H;
  const float* q = static_cast<const float*>(p.q) + (size_t)bh * p.Tq * D;
  const float* k = static_cast<const float*>(p.k) + (size_t)bh * p.Tk * D;
  const float* v = static_cast<const float*>(p.v) + (size_t)bh * p.Tk * D;
  const float* dout =
      static_cast<const float*>(p.dout) + (size_t)bh * p.Tq * D;
  const float* lse = p.lse + (size_t)bh * p.Tq;
  const float* delta = p.delta + (size_t)bh * p.Tq;

  stage_rows_f32<D>(sK, k, k0, p.Tk, tid);
  stage_rows_f32<D>(sV, v, k0, p.Tk, tid);
  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int kvlen = valid_keys(p, b);
  const int it_end = k0 < kvlen ? p.n_qtiles : 0;
  for (int it = first_query_tile(p, k0); it < it_end; ++it) {
    const int q0 = it * BQ;
    __syncthreads();
    stage_rows_f32<D>(sQ, q, q0, p.Tq, tid);
    stage_rows_f32<D>(sdO, dout, q0, p.Tq, tid);
    for (int i = tid; i < BQ; i += 256) {
      const bool in = q0 + i < p.Tq;
      sLse[i] = in ? lse[q0 + i] : 0.f;
      sDelta[i] = in ? delta[q0 + i] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float ka[4], va[4], qb[4], ob[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = sK[(tr * 4 + i) * LQ + d];
        va[i] = sV[(tr * 4 + i) * LQ + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qb[j] = sQ[(tc + 16 * j) * LQ + d];
        ob[j] = sdO[(tc + 16 * j) * LQ + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] += ka[i] * qb[j];
          dpt[i][j] += va[i] * ob[j];
        }
    }
    const bool full = tile_unmasked(p, kvlen, q0, k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tc + 16 * j;
        float pv = 0.f;
        if (full || visible(p, b, kvlen, q0 + qc, k0 + tr * 4 + i))
          pv = expf(st[i][j] * p.scale - sLse[qc]);
        sP[(tr * 4 + i) * LS + qc] = pv;
        sDS[(tr * 4 + i) * LS + qc] =
            pv * (dpt[i][j] - sDelta[qc]) * p.scale;
      }
    }
    __syncthreads();
    for (int c = 0; c < BQ; ++c) {
      float pa[4], da[4], ob[DJ], qb[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = sP[(tr * 4 + i) * LS + c];
        da[i] = sDS[(tr * 4 + i) * LS + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ob[j] = sdO[c * LQ + tc + 16 * j];
        qb[j] = sQ[c * LQ + tc + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv[i][j] += pa[i] * ob[j];
          dk[i][j] += da[i] * qb[j];
        }
    }
  }

  float* dkp = static_cast<float*>(p.dk) + (size_t)bh * p.Tk * D;
  float* dvp = static_cast<float*>(p.dv) + (size_t)bh * p.Tk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + tr * 4 + i;
    if (key >= p.Tk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkp[(size_t)key * D + tc + 16 * j] = dk[i][j];
      dvp[(size_t)key * D + tc + 16 * j] = dv[i][j];
    }
  }
}

template <int D>
constexpr size_t bwd_q_f32_smem_bytes() {
  return (4 * (size_t)64 * (D + 1) + (size_t)64 * (64 + 1) + 2 * 64) *
         sizeof(float);
}

// dQ of one 64-query tile in f32 with scalar FMAs (256 threads), the same
// thread roles as flash_bwd_kv_f32 with query rows for key rows.
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_q_f32(BwdParams p) {
  constexpr int LQ = D + 1;
  constexpr int LS = BK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) float smf[];
  float* sQ = smf;
  float* sdO = sQ + BQ * LQ;
  float* sK = sdO + BQ * LQ;
  float* sV = sK + BK * LQ;
  float* sDS = sV + BK * LQ;
  float* sLse = sDS + BQ * LS;
  float* sDelta = sLse + BQ;

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int bh = blockIdx.x / p.n_qtiles;
  const int q0 = (blockIdx.x % p.n_qtiles) * BQ;
  const int b = bh / p.H;
  const float* q = static_cast<const float*>(p.q) + (size_t)bh * p.Tq * D;
  const float* k = static_cast<const float*>(p.k) + (size_t)bh * p.Tk * D;
  const float* v = static_cast<const float*>(p.v) + (size_t)bh * p.Tk * D;
  const float* dout =
      static_cast<const float*>(p.dout) + (size_t)bh * p.Tq * D;

  stage_rows_f32<D>(sQ, q, q0, p.Tq, tid);
  stage_rows_f32<D>(sdO, dout, q0, p.Tq, tid);
  for (int i = tid; i < BQ; i += 256) {
    const bool in = q0 + i < p.Tq;
    sLse[i] = in ? p.lse[(size_t)bh * p.Tq + q0 + i] : 0.f;
    sDelta[i] = in ? p.delta[(size_t)bh * p.Tq + q0 + i] : 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int kvlen = valid_keys(p, b);
  const int n_tiles = key_tiles(p, kvlen, q0);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    __syncthreads();
    stage_rows_f32<D>(sK, k, k0, p.Tk, tid);
    stage_rows_f32<D>(sV, v, k0, p.Tk, tid);
    __syncthreads();

    float sc[4][4], dps[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dps[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = sQ[(tr * 4 + i) * LQ + d];
        oa[i] = sdO[(tr * 4 + i) * LQ + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = sK[(tc + 16 * j) * LQ + d];
        vb[j] = sV[(tc + 16 * j) * LQ + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] += qa[i] * kb[j];
          dps[i][j] += oa[i] * vb[j];
        }
    }
    const bool full = tile_unmasked(p, kvlen, q0, k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pv = 0.f;
        if (full || visible(p, b, kvlen, q0 + r, k0 + tc + 16 * j))
          pv = expf(sc[i][j] * p.scale - sLse[r]);
        sDS[r * LS + tc + 16 * j] = pv * (dps[i][j] - sDelta[r]) * p.scale;
      }
    }
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float da[4], kb[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = sDS[(tr * 4 + i) * LS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kb[j] = sK[c * LQ + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += da[i] * kb[j];
    }
  }

  float* dq = static_cast<float*>(p.dq) + (size_t)bh * p.Tq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq[(size_t)row * D + tc + 16 * j] = acc[i][j];
  }
}

template <typename Kernel>
int launch_bwd(Kernel kernel, const BwdParams& p, long long blocks,
               int threads, size_t smem, cudaStream_t s) {
  if (blocks == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_bf16(const BwdParams& p, int BH, cudaStream_t s) {
  int rc = launch_bwd(flash_bwd_q_bf16<D>, p, (long long)BH * p.n_qtiles,
                      128, bwd_q_bf16_smem_bytes<D>(), s);
  if (rc != 0) return rc;
  return launch_bwd(flash_bwd_kv_bf16<D>, p, (long long)BH * p.n_ktiles,
                    128, bwd_kv_bf16_smem_bytes<D>(), s);
}

template <int D>
int launch_bwd_f32(const BwdParams& p, int BH, cudaStream_t s) {
  int rc = launch_bwd(flash_bwd_q_f32<D>, p, (long long)BH * p.n_qtiles,
                      256, bwd_q_f32_smem_bytes<D>(), s);
  if (rc != 0) return rc;
  return launch_bwd(flash_bwd_kv_f32<D>, p, (long long)BH * p.n_ktiles,
                    256, bwd_kv_f32_smem_bytes<D>(), s);
}

}  // namespace

// q: BH x Tq x D, k and v: BH x Tk x D, o: BH x Tq x D, all contiguous, of
// `dtype` (0 = float32, 1 = bfloat16), D = 64 or 128, the pointers 16-byte
// aligned; lse: BH x Tq floats.  lens: B ints or null; qseg: B x Tq ints and
// kseg: B x Tk ints, or both null; B = BH / H.  Returns a cudaError_t as int
// (0 = ok).
extern "C" int mx_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      const void* lens, const void* qseg,
                                      const void* kseg, int BH, int H, int Tq,
                                      int Tk, int D, float scale, int causal,
                                      int dtype, void* stream) {
  if (BH < 0 || H <= 0 || BH % H != 0 || Tq < 0 || Tk < 0 ||
      (D != 64 && D != 128) || dtype < 0 || dtype > 1 ||
      (qseg == nullptr) != (kseg == nullptr))
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Tq == 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.lens = static_cast<const int*>(lens);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.n_qtiles = (Tq + BQ - 1) / BQ;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D == 64)
      return launch(flash_fwd_bf16<64>, p, BH, 128, bf16_smem_bytes<64>(), s);
    return launch(flash_fwd_bf16<128>, p, BH, 128, bf16_smem_bytes<128>(), s);
  }
  if (D == 64)
    return launch(flash_fwd_f32<64>, p, BH, 256, f32_smem_bytes<64>(), s);
  return launch(flash_fwd_f32<128>, p, BH, 256, f32_smem_bytes<128>(), s);
}

// The backward of mx_flash_attention_fwd.  q, o and dout: BH x Tq x D; k and
// v: BH x Tk x D; all contiguous, of `dtype`, D = 64 or 128, the pointers
// 16-byte aligned; lse: the forward's BH x Tq floats; delta: BH x Tq floats
// of scratch.  dq (BH x Tq x D), dk and dv (BH x Tk x D), of `dtype`, are
// written whole: rows of dk and dv past a row's valid length are zeros.
// lens, qseg, kseg, H, scale and causal as for the forward.  Three kernels
// run in turn on `stream`: delta = rowsum(dout * o), dq, then dk and dv.
// Returns a cudaError_t as int (0 = ok).
extern "C" int mx_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* dout,
                                      void* delta, void* dq, void* dk,
                                      void* dv, const void* lens,
                                      const void* qseg, const void* kseg,
                                      int BH, int H, int Tq, int Tk, int D,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (BH < 0 || H <= 0 || BH % H != 0 || Tq < 0 || Tk < 0 ||
      (D != 64 && D != 128) || dtype < 0 || dtype > 1 ||
      (qseg == nullptr) != (kseg == nullptr))
    return (int)cudaErrorInvalidValue;
  if (BH == 0) return 0;
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = nullptr;
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.lens = static_cast<const int*>(lens);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.n_qtiles = (Tq + BQ - 1) / BQ;
  p.scale = scale;
  p.causal = causal;
  p.dout = dout;
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.n_ktiles = (Tk + BK - 1) / BK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)BH * Tq;
  if (rows > 0) {
    const unsigned blocks = (unsigned)((rows + 3) / 4);
    if (dtype == 1)
      flash_bwd_delta<bf16><<<blocks, 128, 0, s>>>(
          static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
          static_cast<float*>(delta), rows, D);
    else
      flash_bwd_delta<float><<<blocks, 128, 0, s>>>(
          static_cast<const float*>(o), static_cast<const float*>(dout),
          static_cast<float*>(delta), rows, D);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  if (dtype == 1)
    return D == 64 ? launch_bwd_bf16<64>(p, BH, s)
                   : launch_bwd_bf16<128>(p, BH, s);
  return D == 64 ? launch_bwd_f32<64>(p, BH, s) : launch_bwd_f32<128>(p, BH, s);
}
