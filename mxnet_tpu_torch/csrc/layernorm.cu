// LayerNorm forward and backward over the last axis, for sm_90a.
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

// Backward.  Replaces the TPU kernel _ln_bwd_kernel (same file, launched by
// pallas_layer_norm_bwd).  From the forward's x, gamma, mu and rstd and the
// cotangent ct of y:
//
//     xhat = (x - mu) * rstd;  ctg = ct * gamma
//     dx = (ctg - mean(ctg) - xhat * mean(ctg * xhat)) * rstd   (x's dtype)
//     dgamma = sum over rows of ct * xhat;  dbeta = sum of ct    (fp32)
//
// What bounds it: device-memory bytes.  x and ct are read once and dx
// written once (6 B an element in bf16, 12 in f32); at BERT-base's
// (12288, 768) bf16 that is 57 MB, 17 us at 3.35 TB/s.
//
// Design: eight rows a warp, four warps a block.  Each warp keeps its
// row's x-hat and cotangent in registers, folds the two row means by
// shuffles and writes dx; it adds its rows' ct * x-hat and ct into its own
// fp32 column sums in shared memory.  A lane owns fixed columns, so no two
// lanes touch one sum, and the sums are laid out lane-minor (the sum of
// element i of a lane's chunk j at (j * VEC + i) * 32 + lane), so a warp's
// 32 updates land in 32 banks.  The block then writes the four warps' sums,
// folded in warp order, as one row of the fp32 workspace; ln_bwd_finish
// sums the workspace's rows column by column in block order.  No atomics:
// two runs give the same bits.  MPL, the values a lane holds per row, is
// 32 for C <= 1024 and 64 up to 2048: it sizes the register arrays.
constexpr int kBwdWarps = 4;
constexpr int kBwdRowsPerBlock = 8 * kBwdWarps;

// the columns a warp's sums cover: C rounded up to whole 32-lane chunks
__host__ __device__ __forceinline__ int bwd_cols(int C, int vec) {
  return (C + 32 * vec - 1) / (32 * vec) * 32 * vec;
}

template <typename TX, typename TG, typename TC, int VEC, int MPL>
__global__ void __launch_bounds__(32 * kBwdWarps)
ln_bwd(const TX* __restrict__ x, const TG* __restrict__ gamma,
       const float* __restrict__ mu, const float* __restrict__ rstd,
       const TC* __restrict__ ct, TX* __restrict__ dx,
       float* __restrict__ ws, long long N, int C) {
  constexpr int kChunks = MPL / VEC;
  extern __shared__ float sacc[];            // [warp][dgamma, dbeta][cols]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cols = bwd_cols(C, VEC);
  float* accg = sacc + (size_t)warp * 2 * cols;
  float* accb = accg + cols;
  for (int c = lane; c < cols; c += 32) accg[c] = accb[c] = 0.f;
  __syncwarp();
  const long long row0 = (long long)blockIdx.x * kBwdRowsPerBlock;
  const long long row_end =
      row0 + kBwdRowsPerBlock < N ? row0 + kBwdRowsPerBlock : N;
  for (long long row = row0 + warp; row < row_end; row += kBwdWarps) {
    const float m = mu[row], rs = rstd[row];
    float xh[kChunks][VEC], cg[kChunks][VEC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c0 = (j * 32 + lane) * VEC;
      if (c0 < C) {
        float g[VEC];
        load_vec<TX, VEC>(x + row * C + c0, xh[j]);
        load_vec<TC, VEC>(ct + row * C + c0, cg[j]);
        load_vec<TG, VEC>(gamma + c0, g);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float h = (xh[j][i] - m) * rs;
          const float c = cg[j][i];
          const int slot = (j * VEC + i) * 32 + lane;
          accg[slot] += c * h;
          accb[slot] += c;
          const float cgv = c * g[i];
          s1 += cgv;
          s2 += cgv * h;
          xh[j][i] = h;
          cg[j][i] = cgv;
        }
      }
    }
    const float m1 = warp_sum(s1) / (float)C;
    const float m2 = warp_sum(s2) / (float)C;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c0 = (j * 32 + lane) * VEC;
      if (c0 < C) {
        float out[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          out[i] = (cg[j][i] - m1 - xh[j][i] * m2) * rs;
        store_vec<TX, VEC>(dx + row * C + c0, out);
      }
    }
  }
  __syncthreads();
  float* wsg = ws + (size_t)blockIdx.x * 2 * C;
  for (int c = threadIdx.x; c < C; c += 32 * kBwdWarps) {
    const int slot =
        ((c / (32 * VEC)) * VEC + c % VEC) * 32 + (c / VEC) % 32;
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) {
      sg += sacc[(size_t)w * 2 * cols + slot];
      sb += sacc[(size_t)w * 2 * cols + cols + slot];
    }
    wsg[c] = sg;
    wsg[C + c] = sb;
  }
}

// dgamma[c] and dbeta[c]: the workspace's `blocks` rows summed in a fixed
// order.  A block takes 32 columns; its 8 warps sum every 8th row each,
// in order, and the first warp folds the 8 partial sums in order.
constexpr int kFinishSlices = 8;

__global__ void __launch_bounds__(32 * kFinishSlices)
ln_bwd_finish(const float* __restrict__ ws, float* __restrict__ dgamma,
              float* __restrict__ dbeta, int blocks, int C) {
  __shared__ float part[2][kFinishSlices][32];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float sg = 0.f, sb = 0.f;
  if (c < C) {
    for (int b = ty; b < blocks; b += kFinishSlices) {
      sg += ws[(size_t)b * 2 * C + c];
      sb += ws[(size_t)b * 2 * C + C + c];
    }
  }
  part[0][ty][tx] = sg;
  part[1][ty][tx] = sb;
  __syncthreads();
  if (ty == 0 && c < C) {
    sg = sb = 0.f;
#pragma unroll
    for (int y = 0; y < kFinishSlices; ++y) {
      sg += part[0][y][tx];
      sb += part[1][y][tx];
    }
    dgamma[c] = sg;
    dbeta[c] = sb;
  }
}

template <typename TX, typename TG, typename TC, int VEC, int MPL>
int launch_bwd_rows(const void* x, const void* g, const float* mu,
                    const float* rstd, const void* ct, void* dx, float* ws,
                    long long N, int C, cudaStream_t s) {
  const long long blocks = (N + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock;
  const size_t smem = (size_t)kBwdWarps * 2 * bwd_cols(C, VEC) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd<TX, TG, TC, VEC, MPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ln_bwd<TX, TG, TC, VEC, MPL><<<blocks, 32 * kBwdWarps, smem, s>>>(
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
  const bool narrow = C <= 32 * 32;
  int rc;
  if (aligned && narrow)
    rc = launch_bwd_rows<TX, TG, TC, VEC, 32>(x, g, mu, rstd, ct, dx, ws, N,
                                              C, s);
  else if (aligned)
    rc = launch_bwd_rows<TX, TG, TC, VEC, 64>(x, g, mu, rstd, ct, dx, ws, N,
                                              C, s);
  else if (narrow)
    rc = launch_bwd_rows<TX, TG, TC, 1, 32>(x, g, mu, rstd, ct, dx, ws, N,
                                            C, s);
  else
    rc = launch_bwd_rows<TX, TG, TC, 1, 64>(x, g, mu, rstd, ct, dx, ws, N,
                                            C, s);
  if (rc != 0) return rc;
  const int blocks = (int)((N + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock);
  ln_bwd_finish<<<(C + 31) / 32, 32 * kFinishSlices, 0, s>>>(ws, dg, db,
                                                            blocks, C);
  return (int)cudaGetLastError();
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

// Rows of fp32 workspace mx_layer_norm_bwd needs for N rows (each of 2 C
// floats).
extern "C" long long mx_layer_norm_bwd_blocks(long long N) {
  return (N + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock;
}

// The backward of mx_layer_norm_fwd.  x: N rows of C elements of x_dtype;
// gamma: C elements of g_dtype; mu, rstd: the forward's N floats; ct: N rows
// of C elements, bfloat16 when both dtypes are 1 and float32 otherwise (the
// dtype of y); dx: N rows of C elements of x_dtype; ws: 2 C
// mx_layer_norm_bwd_blocks(N) floats of scratch; dgamma, dbeta: C floats.
// Returns a cudaError_t as int (0 = ok).
extern "C" int mx_layer_norm_bwd(const void* x, const void* gamma,
                                 const void* mu, const void* rstd,
                                 const void* ct, void* dx, void* ws,
                                 void* dgamma, void* dbeta, long long N,
                                 int C, int x_dtype, int g_dtype,
                                 void* stream) {
  if (N < 0 || C <= 0 || C > kMaxChannels || x_dtype < 0 || x_dtype > 1 ||
      g_dtype < 0 || g_dtype > 1)
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
  if (x_dtype == 0 && g_dtype == 0)
    return launch_bwd<float, float, float>(x, gamma, m, r, ct, dx, w, dg, db,
                                           N, C, s);
  if (x_dtype == 0)
    return launch_bwd<float, bf16, float>(x, gamma, m, r, ct, dx, w, dg, db,
                                          N, C, s);
  if (g_dtype == 0)
    return launch_bwd<bf16, float, float>(x, gamma, m, r, ct, dx, w, dg, db,
                                          N, C, s);
  return launch_bwd<bf16, bf16, bf16>(x, gamma, m, r, ct, dx, w, dg, db, N,
                                      C, s);
}
