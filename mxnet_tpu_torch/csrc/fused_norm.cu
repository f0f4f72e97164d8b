// Fused BatchNorm -> residual add -> ReLU epilogue, forward, for sm_90a.
//
// Replaces the TPU kernel _epi_fwd_kernel (mxnet_tpu/ops/pallas_fused_norm.py,
// launched by pallas_epilogue_fwd).  It computes
//
//     y[j] = relu(x[j] * scale[c] + shift[c] + r[j]),   c = (j / trail) % C
//
// over a contiguous tensor whose channel axis has C entries and `trail`
// elements after it (H*W for NCHW, 1 for NHWC or a 2-D (rows, C) view).  The
// math is fp32; x, r and y are all f32 or all bf16; scale and shift are fp32.
//
// What bounds it: device-memory bytes.  Every element reads x and r once and
// writes y once (12 B in f32, 6 B in bf16).  scale and shift are C floats
// each, a few KB that stay in L1/L2, and the arithmetic (one multiply, two
// adds, a max) is far below the card's rate.
//
// Design: a simple vectorised pass.  A flat grid-stride loop moves one
// 16-byte vector of x, r and y per thread per step (4 f32 or 8 bf16) when the
// three pointers are 16-byte aligned, and a scalar loop covers the tail (or
// everything, when they are not aligned).  The channel index comes from the
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
// uses, so an f32 result equals the plain version's bit for bit and a bf16
// result rounds the same fp32 value once.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, allocates nothing and does not synchronise; the function returns
// cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t as int (0 = ok).
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
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
