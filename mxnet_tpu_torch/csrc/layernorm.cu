// LayerNorm forward and backward over the last axis, for sm_90a.
//
// Replaces the TPU kernel _ln_fwd_kernel (mxnet_tpu/ops/pallas_layernorm.py,
// launched by pallas_layer_norm_fwd).  For every row of x (N, C):
//
//     mu = mean(x);  var = mean((x - mu)^2);  rstd = rsqrt(var + eps)
//     y = (x - mu) * rstd * gamma + beta
//
// in fp32, y cast once to its dtype, and mu and rstd written as (N,) fp32
// beside it.  x is f32, bf16 or f16; gamma and beta share one dtype, f32, bf16
// or f16; y is the type promotion of (x, gamma, beta) that the TPU kernel
// applies (jnp.result_type): x's dtype when gamma's is the same, f32
// otherwise (bf16 with f16 promotes to f32 too).  An f16 value past 65504
// rounds to inf, as astype gives.
//
// What bounds it: device-memory bytes.  Each element is read once and written
// once (4 B in bf16 or f16, 8 B in f32) and each row writes 8 B of statistics;
// about eight operations an element are far below the card's rate.  At
// BERT-base's (12288, 768) bf16 that is 37.8 MB, 11.3 us at 3.35 TB/s.
//
// Design: one warp per row, four rows per 128-thread block.  The TPU kernel
// takes 512-row blocks through VMEM; here a row of up to 2048 channels fits
// in one warp's registers, so the row is read from device memory once and
// the two-pass variance (mean first, then the squared deviations) costs no
// second read.  Lane l holds the chunks l, l + 32, l + 64, ... of VEC
// elements, loaded with 16-byte loads (8 bf16 or f16, or 4 f32) when C is a
// multiple of VEC and every pointer is 16-byte aligned, one element at a time
// otherwise.  The sums fold across the warp with shuffles.  C above 2048
// (64 values a lane) is not taken: the caller routes such rows to the
// composed LayerNorm, as the JAX package does past its VMEM budget.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kMaxPerLane = 64;           // C <= 32 * 64 = 2048
constexpr int kMaxChannels = 32 * kMaxPerLane;

typedef __nv_bfloat16 bf16;
typedef __half f16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(f16 v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ f16 from_f<f16>(float v) {
  return __float2half_rn(v);
}

// VEC elements at p as fp32; 16-byte loads when they span whole 16 bytes
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr ((VEC * sizeof(T)) % 16 == 0) {
    constexpr int N16 = VEC * sizeof(T) / 16;
    uint4 raw[N16];
#pragma unroll
    for (int i = 0; i < N16; ++i)
      raw[i] = reinterpret_cast<const uint4*>(p)[i];
    const T* v = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  if constexpr ((VEC * sizeof(T)) % 16 == 0) {
    constexpr int N16 = VEC * sizeof(T) / 16;
    uint4 raw[N16];
    T* v = reinterpret_cast<T*>(raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = from_f<T>(in[i]);
#pragma unroll
    for (int i = 0; i < N16; ++i) reinterpret_cast<uint4*>(p)[i] = raw[i];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f<T>(in[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TX, typename TG, typename TY, int VEC>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ln_fwd(const TX* __restrict__ x, const TG* __restrict__ gamma,
       const TG* __restrict__ beta, TY* __restrict__ y,
       float* __restrict__ mu_out, float* __restrict__ rstd_out, long long N,
       int C, float eps) {
  constexpr int kChunks = kMaxPerLane / VEC;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  const TX* xr = x + row * C;
  float v[kChunks][VEC];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c0 = (j * 32 + lane) * VEC;
    if (c0 < C) {
      load_vec<TX, VEC>(xr + c0, v[j]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum += v[j][i];
    }
  }
  const float mu = warp_sum(sum) / (float)C;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c0 = (j * 32 + lane) * VEC;
    if (c0 < C) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[j][i] - mu;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)C + eps);
  TY* yr = y + row * C;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c0 = (j * 32 + lane) * VEC;
    if (c0 < C) {
      float g[VEC], b[VEC], out[VEC];
      load_vec<TG, VEC>(gamma + c0, g);
      load_vec<TG, VEC>(beta + c0, b);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        out[i] = (v[j][i] - mu) * rstd * g[i] + b[i];
      store_vec<TY, VEC>(yr + c0, out);
    }
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename TX, typename TG, typename TY>
void launch(const void* x, const void* g, const void* b, void* y, float* mu,
            float* rstd, long long N, int C, float eps, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(TX);
  const bool aligned =
      C % VEC == 0 && ((uintptr_t)x | (uintptr_t)g | (uintptr_t)b |
                       (uintptr_t)y) % 16 == 0;
  const long long blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 block(32 * kRowsPerBlock);
  if (aligned) {
    ln_fwd<TX, TG, TY, VEC><<<blocks, block, 0, s>>>(
        (const TX*)x, (const TG*)g, (const TG*)b, (TY*)y, mu, rstd, N, C, eps);
  } else {
    ln_fwd<TX, TG, TY, 1><<<blocks, block, 0, s>>>(
        (const TX*)x, (const TG*)g, (const TG*)b, (TY*)y, mu, rstd, N, C, eps);
  }
}

// Backward.  Replaces the TPU kernel _ln_bwd_kernel (same file, launched by
// pallas_layer_norm_bwd).  From the forward's x, gamma, mu and rstd and the
// cotangent ct of y:
//
//     xhat = (x - mu) * rstd;  ctg = ct * gamma
//     dx = (ctg - mean(ctg) - xhat * mean(ctg * xhat)) * rstd   (x's dtype)
//     dgamma = sum over rows of ct * xhat;  dbeta = sum of ct    (fp32)
//
// What bounds it: device-memory bytes.  x and ct are read once and dx
// written once (6 B an element in bf16 or f16, 12 in f32); at BERT-base's
// (12288, 768) bf16 that is 57 MB, 17 us at 3.35 TB/s.
//
// Design: a grid of one block of eight warps an SM (ln_bwd_grid), each
// block a contiguous range of rows, each warp every eighth row of it.  A
// lane owns fixed columns (chunks j * 32 + lane of VEC elements).  For C
// <= 1024 (MPL <= 32 values a lane), while a warp reduces one row the next
// row's x, ct, mu and rstd are already in flight, loaded as raw bits into
// registers one row ahead and converted where they are used, so the loads
// overlap the row's shuffles and stores; the column sums live in the
// lane's registers.  Wider rows are loaded as they are reached and summed
// into the warp's shared memory.  The warp folds the row's two means by
// shuffles and writes dx, and adds the row's ct * x-hat and ct into its
// column sums.  At the end the block folds its eight warps' sums in warp
// order into one row of the fp32 workspace, and ln_bwd_fold sums the
// workspace's rows column by column in block order: 16 row slices a
// column, each summed in order, then the slices in order.  No atomics: two
// runs on one card give the same bits.
constexpr int kBwdWarps = 8;
constexpr int kFoldSlices = 16;
// the workspace's rows: an upper bound on the grid (ln_bwd_grid)
constexpr long long kMaxBwdBlocks = 512;

// the columns a warp's sums cover: C rounded up to whole 32-lane chunks
__host__ __device__ __forceinline__ int bwd_cols(int C, int vec) {
  return (C + 32 * vec - 1) / (32 * vec) * 32 * vec;
}

// VEC elements of T as raw 32-bit words, loaded with 16-byte loads when
// they span whole 16 bytes and converted to fp32 only where they are used
template <typename T, int VEC>
struct RawVec {
  static constexpr int W = (VEC * (int)sizeof(T) + 3) / 4;
  uint32_t w[W];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr ((VEC * sizeof(T)) % 16 == 0) {
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    } else {
      static_assert(VEC == 1, "unaligned chunks are single elements");
      if constexpr (sizeof(T) == 2)
        w[0] = *reinterpret_cast<const unsigned short*>(p);
      else
        w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
  }

  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[i]);
    } else if constexpr (std::is_same<T, f16>::value) {
      const uint32_t word = w[i >> 1];
      return __half2float(__ushort_as_half(
          (unsigned short)((i & 1) ? (word >> 16) : (word & 0xffffu))));
    } else {
      // bf16: the upper 16 bits of an fp32
      const uint32_t word = w[i >> 1];
      return __uint_as_float((i & 1) ? (word & 0xffff0000u) : (word << 16));
    }
  }
};

template <typename TX, typename TG, typename TC, int VEC, int MPL>
__global__ void __launch_bounds__(32 * kBwdWarps, 1)
ln_bwd(const TX* __restrict__ x, const TG* __restrict__ gamma,
       const float* __restrict__ mu, const float* __restrict__ rstd,
       const TC* __restrict__ ct, TX* __restrict__ dx,
       float* __restrict__ ws, long long N, int C) {
  constexpr int kChunks = MPL / VEC;
  constexpr bool kRegSums = MPL <= 32;
  // ln_bwd_fold, launched after this grid, may be scheduled now: it waits
  // for this grid to finish before it reads the workspace
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ float sacc[];            // [warp][dgamma, dbeta][cols]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cols = bwd_cols(C, VEC);
  float* accg = sacc + (size_t)warp * 2 * cols;
  float* accb = accg + cols;
  float sg[kRegSums ? kChunks : 1][VEC], sb[kRegSums ? kChunks : 1][VEC];
  if constexpr (kRegSums) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int i = 0; i < VEC; ++i) sg[j][i] = sb[j][i] = 0.f;
  } else {
    for (int c = lane; c < cols; c += 32) accg[c] = accb[c] = 0.f;
    __syncwarp();
  }
  const long long row_begin = (long long)blockIdx.x * N / gridDim.x;
  const long long row_end = (long long)(blockIdx.x + 1) * N / gridDim.x;

  RawVec<TX, VEC> nx[kChunks];
  RawVec<TC, VEC> nc[kChunks];
  float nm = 0.f, nr = 0.f;
  auto fetch = [&](long long row) {
    nm = mu[row];
    nr = rstd[row];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c0 = (j * 32 + lane) * VEC;
      if (c0 < C) {
        nx[j].load(x + row * C + c0);
        nc[j].load(ct + row * C + c0);
      }
    }
  };
  // dx of one row from its raw bits, its sums into the column sums
  auto row_pass = [&](const RawVec<TX, VEC> (&cx)[kChunks],
                      const RawVec<TC, VEC> (&cc)[kChunks], float m,
                      float rs, long long row) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c0 = (j * 32 + lane) * VEC;
      if (c0 < C) {
        float g[VEC];
        load_vec<TG, VEC>(gamma + c0, g);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float h = (cx[j].get(i) - m) * rs;
          const float c = cc[j].get(i);
          if constexpr (kRegSums) {
            sg[j][i] += c * h;
            sb[j][i] += c;
          } else {
            const int slot = (j * VEC + i) * 32 + lane;
            accg[slot] += c * h;
            accb[slot] += c;
          }
          const float cgv = c * g[i];
          s1 += cgv;
          s2 += cgv * h;
        }
      }
    }
    const float m1 = warp_sum(s1) / (float)C;
    const float m2 = warp_sum(s2) / (float)C;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c0 = (j * 32 + lane) * VEC;
      if (c0 < C) {
        float g[VEC], out[VEC];
        load_vec<TG, VEC>(gamma + c0, g);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float h = (cx[j].get(i) - m) * rs;
          const float cgv = cc[j].get(i) * g[i];
          out[i] = (cgv - m1 - h * m2) * rs;
        }
        store_vec<TX, VEC>(dx + row * C + c0, out);
      }
    }
  };
  // the next row is fetched a row ahead where the sums live in registers;
  // above 32 values a lane two rows' raw bits would not fit beside them
  long long row = row_begin + warp;
  if constexpr (kRegSums) {
    if (row < row_end) fetch(row);
    for (; row < row_end; row += kBwdWarps) {
      RawVec<TX, VEC> cx[kChunks];
      RawVec<TC, VEC> cc[kChunks];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        cx[j] = nx[j];
        cc[j] = nc[j];
      }
      const float m = nm, rs = nr;
      if (row + kBwdWarps < row_end) fetch(row + kBwdWarps);
      row_pass(cx, cc, m, rs, row);
    }
  } else {
    for (; row < row_end; row += kBwdWarps) {
      fetch(row);
      row_pass(nx, nc, nm, nr, row);
    }
  }
  if constexpr (kRegSums) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int slot = (j * VEC + i) * 32 + lane;
        if (slot < cols) {
          accg[slot] = sg[j][i];
          accb[slot] = sb[j][i];
        }
      }
  }
  __syncthreads();
  float* wsg = ws + (size_t)blockIdx.x * 2 * C;
  for (int c = threadIdx.x; c < C; c += 32 * kBwdWarps) {
    const int slot =
        ((c / (32 * VEC)) * VEC + c % VEC) * 32 + (c / VEC) % 32;
    float tg = 0.f, tb = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) {
      tg += sacc[(size_t)w * 2 * cols + slot];
      tb += sacc[(size_t)w * 2 * cols + cols + slot];
    }
    wsg[c] = tg;
    wsg[C + c] = tb;
  }
}

// dgamma and dbeta: the workspace's `blocks` rows of 2 C floats summed
// column by column in a fixed order.  A block takes 32 of the 2 C columns;
// its kFoldSlices warps each sum every kFoldSlices-th row in order (four
// loads in flight), and the first warp adds the slices in order.
__global__ void __launch_bounds__(32 * kFoldSlices)
ln_bwd_fold(const float* __restrict__ ws, float* __restrict__ dgamma,
            float* __restrict__ dbeta, int blocks, int C) {
  __shared__ float part[kFoldSlices][32];
  // launched as a programmatic dependent of ln_bwd: wait until that grid
  // has finished and its workspace rows are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float sum = 0.f;
  if (c < 2 * C) {
    int b = ty;
    for (; b + 3 * kFoldSlices < blocks; b += 4 * kFoldSlices) {
      const float v0 = ws[(size_t)b * 2 * C + c];
      const float v1 = ws[(size_t)(b + kFoldSlices) * 2 * C + c];
      const float v2 = ws[(size_t)(b + 2 * kFoldSlices) * 2 * C + c];
      const float v3 = ws[(size_t)(b + 3 * kFoldSlices) * 2 * C + c];
      sum += v0;
      sum += v1;
      sum += v2;
      sum += v3;
    }
    for (; b < blocks; b += kFoldSlices) sum += ws[(size_t)b * 2 * C + c];
  }
  part[ty][tx] = sum;
  __syncthreads();
  if (ty == 0 && c < 2 * C) {
    sum = 0.f;
#pragma unroll
    for (int y = 0; y < kFoldSlices; ++y) sum += part[y][tx];
    if (c < C)
      dgamma[c] = sum;
    else
      dbeta[c - C] = sum;
  }
}

// the grid of ln_bwd for N rows: one block an SM of the current device, at
// least kBwdWarps rows a block, at most kMaxBwdBlocks blocks
int ln_bwd_grid(long long N, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long g = (N + kBwdWarps - 1) / kBwdWarps;
  if (g > sms) g = sms;
  if (g > kMaxBwdBlocks) g = kMaxBwdBlocks;
  *grid = (int)(g > 0 ? g : 1);
  return 0;
}

template <typename TX, typename TG, typename TC, int VEC, int MPL>
int launch_bwd_rows(const void* x, const void* g, const float* mu,
                    const float* rstd, const void* ct, void* dx, float* ws,
                    long long N, int C, int grid, cudaStream_t s) {
  const size_t smem = (size_t)kBwdWarps * 2 * bwd_cols(C, VEC) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd<TX, TG, TC, VEC, MPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ln_bwd<TX, TG, TC, VEC, MPL><<<grid, 32 * kBwdWarps, smem, s>>>(
      (const TX*)x, (const TG*)g, mu, rstd, (const TC*)ct, (TX*)dx, ws, N,
      C);
  return (int)cudaGetLastError();
}

template <typename TX, typename TG, typename TC>
int launch_bwd(const void* x, const void* g, const float* mu,
               const float* rstd, const void* ct, void* dx, float* ws,
               float* dg, float* db, long long N, int C, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(TX);
  const bool aligned =
      C % VEC == 0 && ((uintptr_t)x | (uintptr_t)g | (uintptr_t)ct |
                       (uintptr_t)dx) % 16 == 0;
  int grid = 0;
  int rc = ln_bwd_grid(N, &grid);
  if (rc != 0) return rc;
  // the values a lane holds: MPL = 24, 32 or 64 (C <= 768, 1024, 2048)
  // where the chunks are 16-byte vectors, 32 or 64 otherwise
  if (aligned && C <= 32 * 24)
    rc = launch_bwd_rows<TX, TG, TC, VEC, 24>(x, g, mu, rstd, ct, dx, ws, N,
                                              C, grid, s);
  else if (aligned && C <= 32 * 32)
    rc = launch_bwd_rows<TX, TG, TC, VEC, 32>(x, g, mu, rstd, ct, dx, ws, N,
                                              C, grid, s);
  else if (aligned)
    rc = launch_bwd_rows<TX, TG, TC, VEC, 64>(x, g, mu, rstd, ct, dx, ws, N,
                                              C, grid, s);
  else if (C <= 32 * 32)
    rc = launch_bwd_rows<TX, TG, TC, 1, 32>(x, g, mu, rstd, ct, dx, ws, N,
                                            C, grid, s);
  else
    rc = launch_bwd_rows<TX, TG, TC, 1, 64>(x, g, mu, rstd, ct, dx, ws, N,
                                            C, grid, s);
  if (rc != 0) return rc;
  // the fold as a programmatic dependent launch: its launch overlaps the
  // rows kernel's tail instead of following it
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((2 * C + 31) / 32);
  cfg.blockDim = dim3(32 * kFoldSlices);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, ln_bwd_fold, (const float*)ws, dg, db,
                                 grid, C);
}

// the element type of a dtype code (0 = float32, 1 = bfloat16,
// 2 = float16) and the type of y for x and gamma of two such types: x's type
// when both are the same, float32 otherwise, as jnp.result_type promotes
template <int Code>
using Elem = std::conditional_t<Code == 0, float,
                                std::conditional_t<Code == 1, bf16, f16>>;
template <int XC, int GC>
using Out = std::conditional_t<XC == GC, Elem<XC>, float>;

// the forward and the backward for the dtype codes (XC, GC) of x and gamma
template <int XC, int GC>
int fwd_typed(const void* x, const void* g, const void* b, void* y, float* mu,
              float* rstd, long long N, int C, float eps, cudaStream_t s) {
  launch<Elem<XC>, Elem<GC>, Out<XC, GC>>(x, g, b, y, mu, rstd, N, C, eps, s);
  return (int)cudaGetLastError();
}

template <int XC, int GC>
int bwd_typed(const void* x, const void* g, const float* mu,
              const float* rstd, const void* ct, void* dx, float* ws,
              float* dg, float* db, long long N, int C, cudaStream_t s) {
  return launch_bwd<Elem<XC>, Elem<GC>, Out<XC, GC>>(x, g, mu, rstd, ct, dx,
                                                     ws, dg, db, N, C, s);
}

// indexed by x_dtype * 3 + g_dtype
constexpr decltype(&fwd_typed<0, 0>) kFwd[9] = {
    fwd_typed<0, 0>, fwd_typed<0, 1>, fwd_typed<0, 2>,
    fwd_typed<1, 0>, fwd_typed<1, 1>, fwd_typed<1, 2>,
    fwd_typed<2, 0>, fwd_typed<2, 1>, fwd_typed<2, 2>};
constexpr decltype(&bwd_typed<0, 0>) kBwd[9] = {
    bwd_typed<0, 0>, bwd_typed<0, 1>, bwd_typed<0, 2>,
    bwd_typed<1, 0>, bwd_typed<1, 1>, bwd_typed<1, 2>,
    bwd_typed<2, 0>, bwd_typed<2, 1>, bwd_typed<2, 2>};

}  // namespace

// The largest C the kernel takes.
extern "C" int mx_layer_norm_max_channels() { return kMaxChannels; }

// x: N rows of C elements of x_dtype (0 = float32, 1 = bfloat16,
// 2 = float16); gamma and beta: C elements of g_dtype; y: N rows of C
// elements of x_dtype when the two dtypes are the same and float32
// otherwise; mu, rstd: N floats.  Returns a cudaError_t as int (0 = ok).
extern "C" int mx_layer_norm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, void* mu,
                                 void* rstd, long long N, int C, float eps,
                                 int x_dtype, int g_dtype, void* stream) {
  if (N < 0 || C <= 0 || C > kMaxChannels || x_dtype < 0 || x_dtype > 2 ||
      g_dtype < 0 || g_dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mu);
  float* r = static_cast<float*>(rstd);
  return kFwd[x_dtype * 3 + g_dtype](x, gamma, beta, y, m, r, N, C, eps, s);
}

// Rows of fp32 workspace mx_layer_norm_bwd needs for N rows (each of 2 C
// floats): at least its grid on any device.
extern "C" long long mx_layer_norm_bwd_blocks(long long N) {
  const long long g = (N + kBwdWarps - 1) / kBwdWarps;
  return g < 1 ? 1 : (g > kMaxBwdBlocks ? kMaxBwdBlocks : g);
}

// The backward of mx_layer_norm_fwd.  x: N rows of C elements of x_dtype;
// gamma: C elements of g_dtype; mu, rstd: the forward's N floats; ct: N rows
// of C elements in the dtype of y (x_dtype when the two dtypes are the same,
// float32 otherwise); dx: N rows of C elements of x_dtype; ws: 2 C
// mx_layer_norm_bwd_blocks(N) floats of scratch; dgamma, dbeta: C floats.
// Returns a cudaError_t as int (0 = ok).
extern "C" int mx_layer_norm_bwd(const void* x, const void* gamma,
                                 const void* mu, const void* rstd,
                                 const void* ct, void* dx, void* ws,
                                 void* dgamma, void* dbeta, long long N,
                                 int C, int x_dtype, int g_dtype,
                                 void* stream) {
  if (N < 0 || C <= 0 || C > kMaxChannels || x_dtype < 0 || x_dtype > 2 ||
      g_dtype < 0 || g_dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mu);
  const float* r = static_cast<const float*>(rstd);
  float* w = static_cast<float*>(ws);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  if (N == 0) {
    cudaError_t err = cudaMemsetAsync(dg, 0, C * sizeof(float), s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(db, 0, C * sizeof(float), s);
    return (int)err;
  }
  return kBwd[x_dtype * 3 + g_dtype](x, gamma, m, r, ct, dx, w, dg, db, N, C,
                                     s);
}
