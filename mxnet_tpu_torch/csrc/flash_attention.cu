// Flash-attention forward, for sm_90a.
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
