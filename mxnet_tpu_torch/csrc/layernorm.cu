// LayerNorm forward over the last axis, for sm_90a.
//
// Replaces the TPU kernel _ln_fwd_kernel (mxnet_tpu/ops/pallas_layernorm.py,
// launched by pallas_layer_norm_fwd).  For every row of x (N, C):
//
//     mu = mean(x);  var = mean((x - mu)^2);  rstd = rsqrt(var + eps)
//     y = (x - mu) * rstd * gamma + beta
//
// in fp32, y cast once to its dtype, and mu and rstd written as (N,) fp32
// beside it.  x is f32 or bf16; gamma and beta share one dtype, f32 or bf16;
// y is bf16 when x and gamma are both bf16 and f32 otherwise (the type
// promotion of (x, gamma, beta) that the TPU kernel's caller applies).
//
// What bounds it: device-memory bytes.  Each element is read once and written
// once (4 B in bf16, 8 B in f32) and each row writes 8 B of statistics;
// about eight operations an element are far below the card's rate.  At
// BERT-base's (12288, 768) bf16 that is 37.8 MB, 11.3 us at 3.35 TB/s.
//
// Design: one warp per row, four rows per 128-thread block.  The TPU kernel
// takes 512-row blocks through VMEM; here a row of up to 2048 channels fits
// in one warp's registers, so the row is read from device memory once and
// the two-pass variance (mean first, then the squared deviations) costs no
// second read.  Lane l holds the chunks l, l + 32, l + 64, ... of VEC
// elements, loaded with 16-byte loads (8 bf16 or 4 f32) when C is a multiple
// of VEC and every pointer is 16-byte aligned, one element at a time
// otherwise.  The sums fold across the warp with shuffles.  C above 2048
// (64 values a lane) is not taken: the caller routes such rows to the
// composed LayerNorm, as the JAX package does past its VMEM budget.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kMaxPerLane = 64;           // C <= 32 * 64 = 2048
constexpr int kMaxChannels = 32 * kMaxPerLane;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
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

}  // namespace

// The largest C the kernel takes.
extern "C" int mx_layer_norm_max_channels() { return kMaxChannels; }

// x: N rows of C elements of x_dtype (0 = float32, 1 = bfloat16); gamma and
// beta: C elements of g_dtype; y: N rows of C elements, bfloat16 when both
// dtypes are 1 and float32 otherwise; mu, rstd: N floats.  Returns a
// cudaError_t as int (0 = ok).
extern "C" int mx_layer_norm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, void* mu,
                                 void* rstd, long long N, int C, float eps,
                                 int x_dtype, int g_dtype, void* stream) {
  if (N < 0 || C <= 0 || C > kMaxChannels || x_dtype < 0 || x_dtype > 1 ||
      g_dtype < 0 || g_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mu);
  float* r = static_cast<float*>(rstd);
  if (x_dtype == 0 && g_dtype == 0)
    launch<float, float, float>(x, gamma, beta, y, m, r, N, C, eps, s);
  else if (x_dtype == 0)
    launch<float, bf16, float>(x, gamma, beta, y, m, r, N, C, eps, s);
  else if (g_dtype == 0)
    launch<bf16, float, float>(x, gamma, beta, y, m, r, N, C, eps, s);
  else
    launch<bf16, bf16, bf16>(x, gamma, beta, y, m, r, N, C, eps, s);
  return (int)cudaGetLastError();
}
