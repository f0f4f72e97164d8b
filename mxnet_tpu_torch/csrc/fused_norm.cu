// Fused BatchNorm -> residual add -> ReLU epilogue, forward and backward, for
// sm_90a.
//
// Forward.  Replaces the TPU kernel _epi_fwd_kernel
// (mxnet_tpu/ops/pallas_fused_norm.py, launched by pallas_epilogue_fwd).  It
// computes
//
//     y[j] = relu(x[j] * scale[c] + shift[c] + r[j]),   c = (j / trail) % C
//
// over a contiguous tensor whose channel axis has C entries and `trail`
// elements after it (H*W for NCHW, 1 for NHWC or a 2-D (rows, C) view).  The
// math is fp32; x, r and y are all f32, all bf16 or all f16; scale and shift
// are fp32.  A 16-bit y is the fp32 value rounded once to nearest even: an f16
// value past 65504 becomes inf, as the TPU kernel's astype gives.
//
// What bounds it: device-memory bytes.  Every element reads x and r once and
// writes y once (12 B in f32, 6 B in bf16 or f16).  scale and shift are C floats
// each, a few KB that stay in L1/L2, and the arithmetic (one multiply, two
// adds, a max) is far below the card's rate.
//
// Design: a simple vectorised pass.  A flat grid-stride loop moves one
// 16-byte vector of x, r and y per thread per step (4 f32, or 8 bf16 or f16)
// when the three pointers are 16-byte aligned, and a scalar loop covers the
// tail (or everything, when they are not aligned).  The channel index comes from the
// flat index, once per vector, and is carried across the vector's elements,
// so scale and shift are read per channel: the TPU kernel's caller instead
// repeated them per trailing element in device memory.  The TPU kernel's
// (256, 512) row/column tiling is not carried over: at serving batch sizes
// the rows are the batch, 1 to 8, and such tiles would be mostly padding.
// This first design is not tuned (cache hints, bytes in flight per thread,
// grid size); a later change measures and tunes it.
//
// The multiply and the two adds are rounded one at a time (__fmul_rn,
// __fadd_rn: no fused multiply-add), in the order the plain PyTorch version
// uses, so an f32 result equals the plain version's bit for bit and a bf16 or
// f16 result rounds the same fp32 value once.
//
// Backward.  Replaces the TPU kernel _epi_bwd_kernel (same file, launched by
// pallas_epilogue_bwd).  From the forward's x and y and the cotangent ct:
//
//     g = ct * [y > 0];  dx = g * scale[c];  dr = g;
//     dscale[c] = sum g * x;  dshift[c] = sum g      (over all but the channel)
//
// dx and dr are in x's dtype, dscale and dshift fp32.  What bounds it:
// device-memory bytes, as the forward: x, y and ct are read once, dx and dr
// written once (20 B an element in f32, 10 B in bf16 or f16).
//
// What is new against the TPU kernel: that kernel carries the per-channel
// sums in VMEM scratch across the sequential row-block axis of its grid.
// Here blocks run in any order and share nothing, so the channel reduction
// is a deterministic two-stage one, with no atomics: every block writes the
// (dscale, dshift) partial sums of its slice of one channel (or of 32
// channels) into an fp32 workspace the caller allocated, and a second small
// kernel sums each channel's partials in a fixed order.  Within a block each
// thread sums its own elements in order and the block folds the threads'
// sums in a fixed tree, so two runs give the same bits, and the result
// differs from the plain version's only by the order of summation.
//
//  * trail > 1 (NCHW and other channel-major layouts): a channel is N runs of
//    `trail` contiguous elements.  A block takes one channel and a range of
//    the channel's N * trail elements numbered run after run, so a small
//    trail (49 at ResNet-50's last stage) still gives every thread work.
//  * trail == 1 (NHWC, 2-D): channels are contiguous.  A block of 32 x 8
//    threads takes 32 neighbouring channels and a range of rows; a warp reads
//    32 neighbouring channels of one row, and each thread keeps its channel's
//    sums.
//
// This first design is simple and not tuned: scalar loads (no 16-byte
// vectors), one index division per element in the channel-major kernel.
//
// Interface: plain C, loaded with ctypes.  Each launch goes on the caller's
// stream, allocates nothing and does not synchronise; the functions return
// cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

struct F32 {
  typedef float raw;
  static __device__ __forceinline__ float to_f(raw v) { return v; }
  static __device__ __forceinline__ raw from_f(float v) { return v; }
};

struct BF16 {
  typedef unsigned short raw;
  static __device__ __forceinline__ float to_f(raw v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
  static __device__ __forceinline__ raw from_f(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

struct F16 {
  typedef unsigned short raw;
  static __device__ __forceinline__ float to_f(raw v) {
    return __half2float(__ushort_as_half(v));
  }
  static __device__ __forceinline__ raw from_f(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

__device__ __forceinline__ float epilogue(float x, float s, float t, float r) {
  float y = __fadd_rn(__fadd_rn(__fmul_rn(x, s), t), r);
  return y < 0.f ? 0.f : y;  // a NaN stays NaN, as with torch.clamp_min
}

template <typename D>
union Vec16 {
  uint4 u;
  typename D::raw e[16 / sizeof(typename D::raw)];
};

template <typename D, typename Index>
__global__ void __launch_bounds__(256)
epi_fwd_kernel(const typename D::raw* __restrict__ x,
               const float* __restrict__ scale,
               const float* __restrict__ shift,
               const typename D::raw* __restrict__ r,
               typename D::raw* __restrict__ y,
               Index n, Index C, Index trail, bool vectorised) {
  constexpr int VEC = 16 / sizeof(typename D::raw);
  const Index stride = (Index)gridDim.x * blockDim.x;
  const Index tid = (Index)blockIdx.x * blockDim.x + threadIdx.x;
  const Index n_vec = vectorised ? n / VEC : 0;
  for (Index v = tid; v < n_vec; v += stride) {
    const Index j = v * VEC;
    const Index q = j / trail;
    Index rem = j - q * trail;
    Index c = q % C;
    Vec16<D> xv, rv, yv;
    xv.u = reinterpret_cast<const uint4*>(x)[v];
    rv.u = reinterpret_cast<const uint4*>(r)[v];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      yv.e[k] = D::from_f(epilogue(D::to_f(xv.e[k]), __ldg(scale + c),
                                   __ldg(shift + c), D::to_f(rv.e[k])));
      if (++rem == trail) {
        rem = 0;
        if (++c == C) c = 0;
      }
    }
    reinterpret_cast<uint4*>(y)[v] = yv.u;
  }
  for (Index j = n_vec * VEC + tid; j < n; j += stride) {
    const Index c = (j / trail) % C;
    y[j] = D::from_f(epilogue(D::to_f(x[j]), __ldg(scale + c),
                              __ldg(shift + c), D::to_f(r[j])));
  }
}

template <typename D, typename Index>
void launch(const void* x, const void* scale, const void* shift, const void* r,
            void* y, long long n, long long C, long long trail,
            cudaStream_t stream) {
  typedef typename D::raw raw;
  constexpr int VEC = 16 / sizeof(raw);
  const bool vectorised =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
        reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const long long work = vectorised ? n / VEC + n % VEC : n;
  const int threads = 256;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (work + threads - 1) / threads;
  const long long max_blocks = (long long)sms * 8;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  epi_fwd_kernel<D, Index><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const raw*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const raw*>(r),
      static_cast<raw*>(y), (Index)n, (Index)C, (Index)trail, vectorised);
}

template <typename D>
void launch_indexed(const void* x, const void* scale, const void* shift,
                    const void* r, void* y, long long n, long long C,
                    long long trail, cudaStream_t stream) {
  // 32-bit index arithmetic (cheaper division) while the flat index and the
  // grid stride added to it stay far below 2^32
  if (n < (1LL << 30))
    launch<D, unsigned int>(x, scale, shift, r, y, n, C, trail, stream);
  else
    launch<D, unsigned long long>(x, scale, shift, r, y, n, C, trail, stream);
}

// ---------------------------------------------------------------- backward

constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr long long BWD_MAX_SPLITS = 1024;  // blocks per channel (grid.y)

// Sums a and b over the block in a fixed order (warp shuffle tree, then the
// warps' sums in warp order); the totals are valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh[warp] = a;
    sh[BWD_WARPS + warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = sh[0];
    b = sh[BWD_WARPS];
    for (int w = 1; w < BWD_WARPS; ++w) {
      a += sh[w];
      b += sh[BWD_WARPS + w];
    }
  }
}

template <typename D>
__device__ __forceinline__ void epilogue_bwd_elem(
    const typename D::raw* __restrict__ x, const typename D::raw* __restrict__ y,
    const typename D::raw* __restrict__ ct, typename D::raw* __restrict__ dx,
    typename D::raw* __restrict__ dr, float s, unsigned long long j,
    float& acc_s, float& acc_t) {
  // the ReLU mask comes from y, as in the TPU kernel: y > 0 iff the value
  // before the ReLU was positive (a NaN gives no gradient, as in the plain
  // version's torch.where)
  const float g = D::to_f(y[j]) > 0.f ? D::to_f(ct[j]) : 0.f;
  dx[j] = D::from_f(__fmul_rn(g, s));
  dr[j] = D::from_f(g);
  acc_s = __fmaf_rn(g, D::to_f(x[j]), acc_s);
  acc_t = __fadd_rn(acc_t, g);
}

// trail > 1: block (c, split) covers elements [split*chunk, (split+1)*chunk)
// of channel c, numbered run after run (k -> run o = k / trail).
template <typename D, typename Index>
__global__ void __launch_bounds__(BWD_THREADS)
epi_bwd_channel_major(const typename D::raw* __restrict__ x,
                      const float* __restrict__ scale,
                      const typename D::raw* __restrict__ y,
                      const typename D::raw* __restrict__ ct,
                      typename D::raw* __restrict__ dx,
                      typename D::raw* __restrict__ dr,
                      float* __restrict__ part_s, float* __restrict__ part_t,
                      Index C, Index trail, Index per_channel, Index chunk) {
  __shared__ float sh[2 * BWD_WARPS];
  const Index c = blockIdx.x;
  const Index k0 = (Index)blockIdx.y * chunk;
  const Index k1 = per_channel - k0 < chunk ? per_channel : k0 + chunk;
  const float s = __ldg(scale + c);
  float acc_s = 0.f, acc_t = 0.f;
  for (Index k = k0 + threadIdx.x; k < k1; k += BWD_THREADS) {
    const Index o = k / trail;
    const Index j = (o * C + c) * trail + (k - o * trail);
    epilogue_bwd_elem<D>(x, y, ct, dx, dr, s, j, acc_s, acc_t);
  }
  block_sum2(acc_s, acc_t, sh);
  if (threadIdx.x == 0) {
    part_s[(Index)blockIdx.y * C + c] = acc_s;
    part_t[(Index)blockIdx.y * C + c] = acc_t;
  }
}

// trail == 1: a (32, 8) block covers channels [32*blockIdx.x, +32) of rows
// [split*chunk, (split+1)*chunk); thread (tx, ty) takes rows ty, ty+8, ...
template <typename D, typename Index>
__global__ void __launch_bounds__(BWD_THREADS)
epi_bwd_channel_minor(const typename D::raw* __restrict__ x,
                      const float* __restrict__ scale,
                      const typename D::raw* __restrict__ y,
                      const typename D::raw* __restrict__ ct,
                      typename D::raw* __restrict__ dx,
                      typename D::raw* __restrict__ dr,
                      float* __restrict__ part_s, float* __restrict__ part_t,
                      Index C, Index rows, Index chunk) {
  __shared__ float sh_s[8][33], sh_t[8][33];
  const Index c = (Index)blockIdx.x * 32 + threadIdx.x;
  const Index r0 = (Index)blockIdx.y * chunk;
  const Index r1 = rows - r0 < chunk ? rows : r0 + chunk;
  float acc_s = 0.f, acc_t = 0.f;
  if (c < C) {
    const float s = __ldg(scale + c);
    for (Index r = r0 + threadIdx.y; r < r1; r += 8)
      epilogue_bwd_elem<D>(x, y, ct, dx, dr, s, r * C + c, acc_s, acc_t);
  }
  sh_s[threadIdx.y][threadIdx.x] = acc_s;
  sh_t[threadIdx.y][threadIdx.x] = acc_t;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float a = sh_s[0][threadIdx.x], b = sh_t[0][threadIdx.x];
    for (int w = 1; w < 8; ++w) {
      a += sh_s[w][threadIdx.x];
      b += sh_t[w][threadIdx.x];
    }
    part_s[(Index)blockIdx.y * C + c] = a;
    part_t[(Index)blockIdx.y * C + c] = b;
  }
}

// Second stage: each channel's partial sums, in split order.
__global__ void epi_bwd_finish(const float* __restrict__ part_s,
                               const float* __restrict__ part_t,
                               float* __restrict__ ds, float* __restrict__ dt,
                               long long C, int splits) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int s = 0; s < splits; ++s) {
    a += part_s[s * C + c];
    b += part_t[s * C + c];
  }
  ds[c] = a;
  dt[c] = b;
}

// Blocks per channel (splits) and the elements (trail > 1) or rows
// (trail == 1) each covers: 16 elements or 8 rows a thread, at most
// BWD_MAX_SPLITS blocks per channel.
struct BwdPlan {
  long long splits, chunk;
};

BwdPlan bwd_plan(long long n, long long C, long long trail) {
  const long long per = n / C;
  long long chunk = trail > 1 ? 16LL * BWD_THREADS : 64;
  long long splits = (per + chunk - 1) / chunk;
  if (splits > BWD_MAX_SPLITS) {
    chunk = (per + BWD_MAX_SPLITS - 1) / BWD_MAX_SPLITS;
    splits = (per + chunk - 1) / chunk;
  }
  return {splits < 1 ? 1 : splits, chunk};
}

template <typename D, typename Index>
void launch_bwd(const void* x, const void* scale, const void* y, const void* ct,
                void* dx, void* dr, void* ds, void* dt, float* ws,
                long long n, long long C, long long trail, const BwdPlan& p,
                cudaStream_t stream) {
  typedef typename D::raw raw;
  float* part_s = ws;
  float* part_t = ws + p.splits * C;
  const raw* xr = static_cast<const raw*>(x);
  const raw* yr = static_cast<const raw*>(y);
  const raw* cr = static_cast<const raw*>(ct);
  const float* sr = static_cast<const float*>(scale);
  if (trail > 1) {
    const dim3 grid((unsigned)C, (unsigned)p.splits);
    epi_bwd_channel_major<D, Index><<<grid, BWD_THREADS, 0, stream>>>(
        xr, sr, yr, cr, static_cast<raw*>(dx), static_cast<raw*>(dr), part_s,
        part_t, (Index)C, (Index)trail, (Index)(n / C), (Index)p.chunk);
  } else {
    const dim3 grid((unsigned)((C + 31) / 32), (unsigned)p.splits);
    epi_bwd_channel_minor<D, Index><<<grid, dim3(32, 8), 0, stream>>>(
        xr, sr, yr, cr, static_cast<raw*>(dx), static_cast<raw*>(dr), part_s,
        part_t, (Index)C, (Index)(n / C), (Index)p.chunk);
  }
  epi_bwd_finish<<<(unsigned)((C + 255) / 256), 256, 0, stream>>>(
      part_s, part_t, static_cast<float*>(ds), static_cast<float*>(dt), C,
      (int)p.splits);
}

template <typename D>
void launch_bwd_indexed(const void* x, const void* scale, const void* y,
                        const void* ct, void* dx, void* dr, void* ds, void* dt,
                        float* ws, long long n, long long C, long long trail,
                        const BwdPlan& p, cudaStream_t stream) {
  if (n < (1LL << 30))
    launch_bwd<D, unsigned int>(x, scale, y, ct, dx, dr, ds, dt, ws, n, C,
                                trail, p, stream);
  else
    launch_bwd<D, unsigned long long>(x, scale, y, ct, dx, dr, ds, dt, ws, n,
                                      C, trail, p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns a cudaError_t as int
// (0 = ok).
extern "C" int mx_fused_bn_add_relu_fwd(const void* x, const void* scale,
                                        const void* shift, const void* r,
                                        void* y, long long n, long long C,
                                        long long trail, int dtype,
                                        void* stream) {
  if (n <= 0 || C <= 0 || trail <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch_indexed<F32>(x, scale, shift, r, y, n, C, trail, s);
      break;
    case 1:
      launch_indexed<BF16>(x, scale, shift, r, y, n, C, trail, s);
      break;
    case 2:
      launch_indexed<F16>(x, scale, shift, r, y, n, C, trail, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// fp32 workspace floats mx_fused_bn_add_relu_bwd needs for these sizes, or
// -1 when the sizes are not a (n / (C * trail), C, trail) layout.
extern "C" long long mx_fused_bn_add_relu_bwd_workspace(long long n,
                                                        long long C,
                                                        long long trail) {
  if (n <= 0 || C <= 0 || trail <= 0 || n % (C * trail) != 0) return -1;
  return 2 * bwd_plan(n, C, trail).splits * C;
}

// x, y, ct, dx, dr: n elements of `dtype` (0 = float32, 1 = bfloat16,
// 2 = float16); scale, ds, dt: C floats; workspace: workspace_floats floats,
// at least mx_fused_bn_add_relu_bwd_workspace(n, C, trail).  Returns a
// cudaError_t as int (0 = ok).
extern "C" int mx_fused_bn_add_relu_bwd(const void* x, const void* scale,
                                        const void* y, const void* ct,
                                        void* dx, void* dr, void* ds, void* dt,
                                        void* workspace,
                                        long long workspace_floats,
                                        long long n, long long C,
                                        long long trail, int dtype,
                                        void* stream) {
  const long long need = mx_fused_bn_add_relu_bwd_workspace(n, C, trail);
  if (need < 0 || workspace_floats < need) return (int)cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(n, C, trail);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch_bwd_indexed<F32>(x, scale, y, ct, dx, dr, ds, dt, ws, n, C, trail,
                              p, s);
      break;
    case 1:
      launch_bwd_indexed<BF16>(x, scale, y, ct, dx, dr, ds, dt, ws, n, C,
                               trail, p, s);
      break;
    case 2:
      launch_bwd_indexed<F16>(x, scale, y, ct, dx, dr, ds, dt, ws, n, C,
                              trail, p, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
