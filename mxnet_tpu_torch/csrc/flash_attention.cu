// Flash-attention forward and backward, for sm_90a.
//
// Replaces the TPU kernels _fwd_kernel_single and _fwd_kernel
// (mxnet_tpu/ops/pallas_attention.py, launched by pallas_flash_attention and
// pallas_flash_attention_bshd).  For one (batch, head) row of q (Tq, D) and
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
// the caller pads only D (to 64, 128, 192 or 256).
//
// Every kernel addresses its operands through strides (Strides below), so
// one design serves both TPU entries: contiguous (B, H, T, D) operands
// (pallas_flash_attention and its backward) and (B, T, H, D) ones with
// heads as column blocks of each row (the _bshd pair), which may be views
// into a wider row, such as q, k and v as the three column blocks of a fused
// (B, T, 3 H D) projection output, read and written in place: no transposed
// or contiguous copy.  The arithmetic does not depend on the layout.
//
// The kernel each operand type takes:
// - bfloat16 and float16, at D 64, 128, 192 and 256: flash_fwd_hopper,
//   below, whose first template argument is the dtype code (1 = bfloat16,
//   2 = float16).  The two types share every line but the wgmma type (.bf16
//   or .f16), the tensor maps' element type and the roundings of P and O;
//   float16 has bfloat16's tensor-core rate (989 TFLOP/s dense) and bytes,
//   so the same tiles serve both.  At D 192 and 256 O takes 96 and 128 fp32
//   registers a thread, so the kernel is compiled for one block an SM
//   (Fwd16 below).
// - float32, at every D: flash_fwd_tf32, on the tensor cores through
//   mma.sync with three TF32 products for each float32 product (the
//   float32 section below).
//
// flash_fwd_hopper runs on Hopper's asynchronous units, with one warpgroup
// (128 threads) a block owning 64 query rows:
// - Loads.  Thread 0 issues TMA loads (cp.async.bulk.tensor over a 4-d
//   tensor map (D, T, H, B) built from the operand's strides, with the
//   128-byte swizzle and zero fill past T for the ragged last tile) of the
//   Q tile once and of the K and V tiles of 64 keys into a ring of STAGES
//   buffers, each with a "full" mbarrier (the TMA's bytes) and an "empty"
//   one (one arrival per warp once its products on the buffer are done).
//   Thread 0 refills a buffer one tile after its warps released it, so the
//   loads of the next tiles are in flight while the warps compute.
// - Products on wgmma (m64nNk16, 16-bit in, fp32 accumulate).  S = Q K^T
//   takes both operands K-major from shared memory; O += P V takes P from
//   registers (the fp32 scores, exponentiated and rounded to the operands'
//   type, are the A fragments) and V MN-major with the transpose bit from
//   the same swizzled buffer, one 64-column half at a time: no transposed V
//   is staged.
// - The exponentials overlap the tensor cores: each tile's S = Q K^T is
//   issued together with the previous tile's P V, and the tile's softmax
//   runs while that P V does (FlashAttention-3's order inside one
//   warpgroup).  exp2 runs on the special-function unit
//   (ex2.approx) with log2(e) folded into the scale.  A tile with no
//   masked pair runs the softmax without mask tests, one masked only by
//   the valid length with one test a key, and only causal and segment
//   tiles test each element.
// - O is divided by the normaliser, rounded once to the operands' type,
//   written into the Q tile's buffer in the swizzled layout and stored by
//   TMA, which clips the rows past Tq; lse = m + log(l) goes out from
//   registers.
//
// What bounds it at BERT-base (B 24, H 12, T 512, D 64, bf16): bytes,
// narrowly.  4 B H T^2 D = 19.3 GFLOP a layer is 19.5 us at 989 TFLOP/s; q,
// k, v and o are 75.5 MB, 22.5 us at 3.35 TB/s.  With bench.py's valid
// lengths the keys past them are skipped: 14.5 GFLOP (14.7 us) against 66 MB
// (19.8 us).  Inside a 64 x 64 tile at D 64 the 4,096 exponentials take as
// long on the special-function unit (16 a cycle an SM) as the tile's two
// products on the tensor cores, so the design overlaps the two and keeps
// several blocks on each SM (Fwd16 below); every Q tile of a head reads
// the head's K and V, from L2 after the first.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;

// The 16-bit element types by the C entries' dtype code (0 = float32, 1 =
// bfloat16, 2 = float16), the first template argument of the Hopper
// kernels.
template <int DT>
struct Elem;
template <>
struct Elem<1> {
  typedef bf16 T;
  static constexpr CUtensorMapDataType tma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Elem<2> {
  typedef f16 T;
  static constexpr CUtensorMapDataType tma = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;   // query rows of a block
constexpr int BK = 64;   // keys of a K tile

// Where a (batch, head) row of an operand starts and how far apart its T
// rows lie, in elements: row t of head h of batch b is at b * b + h * h +
// t * t, its D elements contiguous.  A contiguous (B, H, T, D) operand has
// {H T D, D, T D}; a (B, T, H, D) one, or a view of heads as column blocks
// of a wider row (the (B, T, 3 H D) output of a fused projection), has
// {T ld, ld, D} for a row of ld elements.
struct Strides {
  long long b, t, h;
};

// The operands and masks of one call, without their strides.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;        // (B, H, Tq), contiguous
  const int* lens;   // (B,) valid key lengths, or null
  const int* qseg;   // (B, Tq) segment ids, or null
  const int* kseg;   // (B, Tk) segment ids, or null when qseg is
  int H, Tq, Tk, n_qtiles;
  float scale;
  int causal;
};

// q, k, v and o with their strides
struct StridedParams : Params {
  Strides sq, sk, sv, so;
};

// the first element of (batch b, head h) of an operand with strides s
template <typename T>
__device__ __forceinline__ T* head_ptr(T* base, const Strides& s, int b,
                                       int h) {
  return base + (size_t)(b * s.b + h * s.h);
}

// the valid key length of batch row b, clamped to [0, Tk]
__device__ __forceinline__ int valid_keys(const Params& p, int b) {
  if (p.lens == nullptr) return p.Tk;
  return min(max(p.lens[b], 0), p.Tk);
}

// how many K tiles of KEYS keys the Q tile of ROWS rows starting at q0
// visits
template <int ROWS = BQ, int KEYS = BK>
__device__ __forceinline__ int key_tiles(const Params& p, int kvlen, int q0) {
  int end = kvlen;
  if (p.causal) end = min(end, min(q0 + ROWS, p.Tq));
  return end > 0 ? (end + KEYS - 1) / KEYS : 0;
}

// whether no element of the tile of ROWS queries at q0 by KEYS keys at k0
// is masked
template <int ROWS = BQ, int KEYS = BK>
__device__ __forceinline__ bool tile_unmasked(const Params& p, int kvlen,
                                              int q0, int k0) {
  return k0 + KEYS <= kvlen && (!p.causal || q0 >= k0 + KEYS - 1) &&
         p.qseg == nullptr && q0 + ROWS <= p.Tq;
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

// two floats rounded to the 16-bit type of DT (1 or 2) in one 32-bit word,
// lo in the low half
template <int DT>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (DT == 1) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// the two 16-bit values of type DT (1 or 2) in a 32-bit word, widened
template <int DT>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (DT == 1)
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  else
    return __half22float2(*reinterpret_cast<__half2*>(&w));
}

// `blocks` blocks of `kernel` with `smem` bytes of dynamic shared memory
// (above 48 KB only after the opt-in below) on stream s
template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long blocks, int threads, size_t smem,
           cudaStream_t s, const Args&... args) {
  if (blocks == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, smem, s>>>(args...);
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
//     dv = rnd(p)^T dO,  dq = rnd(ds) k,  dk = rnd(ds)^T q
//
// with every product summed in fp32 and p and ds rounded to the operands'
// dtype (rnd: to bfloat16 or float16; nothing for float32) where the TPU
// kernels round them.  One design covers the three TPU
// kernels: a Hopper block holds 64-row tiles, so it always streams, and the
// TPU's single-block kernels are its one-tile case.  It is the TPU's split
// form, deterministic (no atomics): a dQ kernel, a block per 64-query tile
// streaming the K/V tiles, and a dK/dV kernel, a block per 64-key tile
// streaming the Q/dO tiles, both recomputing p from lse.  The bf16 dQ
// and float32 dQ kernels also compute delta for their rows and write it,
// with lse times log2(e), into arrays padded to whole 64-row tiles for the
// dK/dV kernel, launched after it.  Keys past a row's valid length get dk =
// dv = 0.
//
// What bounds it at BERT-base (B 24, H 12, T 512, D 64, bf16, bench.py's
// valid lengths): bytes, narrowly.  q, o, dO and dq whole and k, v, dk and
// dv up to the valid lengths are 137 MB, 41 us at 3.35 TB/s; the five
// products the visible pairs need are 36 GFLOP, 36 us at 989 TFLOP/s.  Both
// kernels recompute s and dp (seven products, 50 GFLOP), and each streamed
// tile is read by every block of its head from L2, so what the card can do
// is set by how well the tensor cores are fed, not by device memory.
//
// The bf16 design (flash_bwd_kv_hopper, flash_bwd_q_hopper), one
// warpgroup (four warps, 128 threads) a block:
// - Asynchronous tile loads in a ring.  Thread 0 issues TMA loads
//   (cp.async.bulk.tensor with a 4-d tensor map over (D, T, H, B) built
//   from the operand's strides, whose zero fill past T covers the ragged
//   last tile of each head; lse2 and delta by
//   cp.async.bulk from their padded arrays) of the resident tile once and
//   of the streamed tiles into a ring of STAGES buffers.  Each buffer has a
//   "full" mbarrier (the TMA's bytes) and an "empty" one (one arrival per
//   warp once its products on the buffer are done).  Thread 0 refills the
//   buffer released one tile earlier, whose arrivals are in by then, right
//   after issuing the current tile's first products, so the refill costs
//   the warpgroup nothing while they run, and the loads of the next
//   STAGES - 1 tiles are in flight while the warps compute.  No
//   __syncthreads runs inside the loop.  A separate producer warp was
//   tried first: it bought nothing the lagged refill does not, and it cost
//   32 threads' registers.
// - Every product runs on wgmma (m64nNk16, bf16 in, fp32 accumulate), the
//   warpgroup owning the block's 64 resident rows.  The tiles lie in shared
//   memory as TMA writes them with the 128-byte swizzle: rows of 64
//   elements (a D = 128 tile is two such halves), 16-byte chunk c of row r
//   at c ^ (r % 8).  S (or S^T) and dP (or dP^T) take both operands from
//   shared memory, K-major, as two commit groups: P is computed while dP
//   is still on the tensor cores.  P and dS never leave registers: the
//   fp32 accumulators, rounded to bf16, are the A fragments of the next
//   product.  The streamed operand whose reduction axis is its row axis
//   (dO and Q for dV and dK, K for dQ) is the B operand in the same
//   buffer, read MN-major with wgmma's transpose bit, one 64-column half
//   (N = 64) at a time: no transposed copy is staged.
// - exp2 on the special-function unit (ex2.approx), with log2(e) folded
//   into the scale and into the padded lse; P and dS are rounded where the
//   TPU kernels round them.  A tile with no masked pair runs the
//   exponentials without mask tests, a tile masked only by the valid
//   length and Tq with one test a key and one a query, and only causal
//   and segment masks test each element: with the element tests in the
//   same unrolled loop the exponential phase took four to five times as
//   long, on full tiles too (chip_diag.py bwd, PERF.md).
// - delta = rowsum(dO * O) is computed in the dQ kernel's prologue, two
//   threads a row, while its first tiles load, and written with lse *
//   log2(e) for the dK/dV kernel: no separate kernel for bf16.
// - Tiles and occupancy (Bwd16 below; chip_smoke.py prints the registers
//   from ptxas -v and the blocks an SM from the CUDA runtime).  dK/dV: 64
//   keys a block, Q/dO tiles of BR = 64 rows at D 64 and 32 at D 128, so
//   that S^T, dP^T, dK and dV stay in registers (4 x 32 fp32 at D 64,
//   2 x 16 + 2 x 64 at D 128); 3 stages.  dQ: 64 queries a block, K/V
//   tiles of 64 keys, 3 stages at D 64 and 2 at D 128.  Each kernel is
//   compiled for 2 blocks an SM (at most 255 registers): at 3 (168) the
//   dK/dV kernel spilled and ran no faster.  At D 64 the dK/dV kernel takes
//   187 registers and 68 KB of shared memory (2 blocks an SM), the dQ
//   kernel 156 and 66 KB (3 blocks an SM); at D 128 202 and 84 KB, 188 and
//   99 KB (2 and 2).  The BERT grids are 2,304 blocks each (24 x 12 heads
//   x 8 tiles); 1,836 dK/dV blocks hold a key below their row's valid
//   length.  No kernel spills at D 64 or 128.
// - One block holds one warpgroup: 64 keys, not 128, a dK/dV block.  Two
//   consumer warpgroups sharing each streamed Q/dO tile would halve that
//   tile's traffic a key, but the traffic is from L2 and the tile loads
//   are not what the warps wait for (PERF.md); the time goes to the
//   exponentials (4,096 a tile, at the special-function unit's 16 a cycle
//   an SM) and the dependent chains of wgmma, which the other blocks on
//   the SM overlap.  Two warpgroups in ping-pong, one's exponentials under
//   the other's products, are the next step.
//
// bfloat16 and float16 take the Hopper kernels at every D (the dtype code
// is their first template argument); the two types differ only in the
// wgmma type, the tensor maps' element type and the roundings of P, dS and
// the outputs.  Above D 128 the accumulators would not fit (dK and dV are
// 2 x 64 x D fp32 in one warpgroup's registers: 256 a thread at D 256), so
// each block accumulates a 64-column slice of dQ (dK and dV) and D / 64
// blocks share a tile, each recomputing S and dP over the whole D (DOUT in
// Bwd16 below).
//
// float32 takes flash_bwd_q_tf32 and flash_bwd_kv_tf32 (the float32
// section below): the same split, on mma.sync with three TF32 products for
// each float32 product.

struct BwdParams : StridedParams {
  const void* dout;    // dO, the shape of o
  void* dq;            // the shape of q
  void* dk;            // the shape of k
  void* dv;            // the shape of v
  Strides sdo, sdq, sdk, sdv;
  int n_ktiles;
};

constexpr float kLog2e = 1.4426950408889634f;

// the first Q tile of `rows` rows that sees any key of the K tile at k0
// (causal: the rows r >= k0)
__device__ __forceinline__ int first_query_tile(const Params& p, int k0,
                                                int rows = BQ) {
  return p.causal ? k0 / rows : 0;
}

// the accumulators of n-tiles 2 kk and 2 kk + 1 (16 rows x 16 columns)
// rounded to the 16-bit type of DT as the A fragment of the next product
template <int DT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* lo,
                                         const float* hi) {
  a[0] = pack2<DT>(lo[0], lo[1]);
  a[1] = pack2<DT>(lo[2], lo[3]);
  a[2] = pack2<DT>(hi[0], hi[1]);
  a[3] = pack2<DT>(hi[2], hi[3]);
}

// ---- Hopper building blocks: mbarriers, TMA, wgmma ------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one (64 x rows) box of a 4-d tensor map (D, T, H, B) at column c0, row
// t0 of head h of batch b into shared memory, its bytes counted on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int t0,
                                            int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(t0),
      "r"(h), "r"(b)
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes into shared memory, counted on
// `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// a wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (both in 16-byte units)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The tiles in shared memory: `rows` rows of D elements as D / 64 halves of
// (rows x 128 bytes), each 1024-byte aligned, swizzled as TMA writes them.
//
// K-major use (the reduction runs along D): k-slice kk is 16 columns, 32
// bytes into its half's rows; groups of 8 rows lie 1024 bytes apart.
__device__ __forceinline__ uint64_t sw_k(uint32_t tile, int rows, int kk) {
  return sw128_desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024);
}

// MN-major use (the reduction runs along the rows, wgmma's transpose bit
// set), one 64-column half (N = 64) at a time: k-slice kk is rows 16 kk ..
// 16 kk + 15, groups of 8 rows 1024 bytes apart.  With one swizzle atom
// along N the leading byte offset is not read.
__device__ __forceinline__ uint64_t sw_mn(uint32_t half, int kk) {
  return sw128_desc(half + kk * 16 * 128, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit (relative error about 2^-22)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keep the compiler from moving reads or writes of accumulators across the
// asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma m64nNk16, 16-bit in (bf16 for DT 1, f16 for DT 2), fp32
// accumulated into d.  _ss: A and B from shared memory, both K-major, d = A
// B where `accumulate` is 0 (the first k-slice) and d += A B elsewhere; _rs:
// d += A B, A from registers (the m16n8k16 A fragments of each warp's 16
// rows), B from shared memory MN-major.
#define MX_WGMMA(N, TY) \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {"
#define MX_ACC16                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define MX_ACC32                                                             \
  MX_ACC16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define MX_SS32(TY)                                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" MX_WGMMA(32, TY) \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                        \
  "%8, %9, %10, %11, %12, %13, %14, %15"                    \
  "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
#define MX_SS64(TY)                                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" MX_WGMMA(64, TY) \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                        \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                \
  "%24, %25, %26, %27, %28, %29, %30, %31"                  \
  "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
#define MX_RS64(TY)                                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" MX_WGMMA(64, TY) \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                        \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                \
  "%24, %25, %26, %27, %28, %29, %30, %31"                  \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"

template <int DT>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (DT == 2)
    asm volatile(MX_SS32("f16") : MX_ACC16
                 : "l"(da), "l"(db), "r"(accumulate));
  else
    asm volatile(MX_SS32("bf16") : MX_ACC16
                 : "l"(da), "l"(db), "r"(accumulate));
}

template <int DT>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (DT == 2)
    asm volatile(MX_SS64("f16") : MX_ACC32
                 : "l"(da), "l"(db), "r"(accumulate));
  else
    asm volatile(MX_SS64("bf16") : MX_ACC32
                 : "l"(da), "l"(db), "r"(accumulate));
}

template <int DT>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DT == 2)
    asm volatile(MX_RS64("f16") : MX_ACC32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  else
    asm volatile(MX_RS64("bf16") : MX_ACC32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
}

// one (64 x 64) box of shared memory at src to column c0, row t0 of head h
// of batch b of a 4-d tensor map, rows past T clipped
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int t0,
                                             int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(t0), "r"(h), "r"(b)
      : "memory");
}

// commit the stores issued so far and wait until they have read shared
// memory
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

constexpr float kLn2 = 0.6931471805599453f;

// ---- the bf16 forward ------------------------------------------------------

// the operands of flash_fwd_hopper: 4-d tensor maps (D, T, H, B) of q, k, v
// and o over their strides, boxes of 64 columns by 64 rows of one head
struct HopperFwd {
  CUtensorMap tq, tk, tv, to;
  StridedParams p;
  float scale_log2;    // scale * log2(e)
};

// shared memory of flash_fwd_hopper, byte offsets from a 1024-byte aligned
// base: the Q tile of 64 x D (reused for the O tile on the way out), then
// STAGES x (K, V) tiles of 64 x D.  The mbarriers go in the alignment
// slack before the base, or after the tiles.
template <int D, int STAGES>
struct FwdSmem {
  static constexpr int tile = 64 * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = tile;                       // + s * 2 tile
  static constexpr int BYTES = K + STAGES * 2 * tile;
  static constexpr int BARS = 8 * (2 * STAGES + 1);
};

// o and lse of the 64 query rows q0 .. q0 + 63, one warpgroup a block.
// Per K tile j: S = Q K^T, x = S scale log2(e) (-1e30 where masked), the
// running row max m (in those units) and normaliser l, P = exp2(x - m), O
// = O exp2(m_old - m) + bf16(P) V.  Accumulator element 4 j + i of a
// thread: row row0 + 8 ((i >> 1) & 1), key (or column) 8 j + 2 t + (i &
// 1).
template <int DT, int D, int STAGES, int MINB>
__global__ void __launch_bounds__(128, MINB)
flash_fwd_hopper(const __grid_constant__ HopperFwd hf) {
  using L = FwdSmem<D, STAGES>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t bars = base - raw >= (uint32_t)L::BARS ? raw
                                                        : base + L::BYTES;
  const StridedParams& p = hf.p;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x / p.n_qtiles;
  const int q0 = (blockIdx.x % p.n_qtiles) * 64;
  const int b = bh / p.H, hd = bh % p.H;
  const int kvlen = valid_keys(p, b);
  const int n_tiles = key_tiles(p, kvlen, q0);
  const uint32_t full0 = bars;
  const uint32_t empty0 = bars + 8 * STAGES;
  const uint32_t qbar = bars + 16 * STAGES;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);    // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues the loads: the Q tile and the first STAGES K/V tiles
  // here, each later tile in refill below
  auto load_tile = [&](int j) {
    const int s = j % STAGES;
    const uint32_t fb = full0 + 8 * s;
    mbar_expect_tx(fb, 2 * L::tile);
    const uint32_t sk = base + L::K + s * 2 * L::tile;
#pragma unroll
    for (int h = 0; h < D / 64; ++h) {
      tma_load_4d(sk + h * 64 * 128, &hf.tk, fb, h * 64, j * 64, hd, b);
      tma_load_4d(sk + L::tile + h * 64 * 128, &hf.tv, fb, h * 64, j * 64,
                  hd, b);
    }
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(qbar, L::tile);
#pragma unroll
    for (int h = 0; h < D / 64; ++h)
      tma_load_4d(base + L::Q + h * 64 * 128, &hf.tq, qbar, h * 64, q0, hd,
                  b);
    for (int j = 0; j < n_tiles && j < STAGES; ++j) load_tile(j);
  }
  // thread 0 refills the buffer of tile m, which every warp released in
  // iteration m + 1, with tile m + STAGES; it does so in iteration m + 2,
  // once every warp has issued that iteration's first product, so the
  // arrivals are in and the refill costs the warpgroup nothing
  auto refill = [&](int m) {
    if (tid == 0 && m >= 0 && m + STAGES < n_tiles) {
      mbar_wait(empty0 + 8 * (m % STAGES), (m / STAGES) & 1);
      load_tile(m + STAGES);
    }
  };

  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;       // this thread's rows: row0, +8
  const uint32_t sq = base + L::Q;
  const float c = hf.scale_log2;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};                   // this thread's share of the sum
  float o[D / 64][32];                       // by 64-column half
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h][i] = 0.f;
  uint32_t pf[4][4];                         // bf16(P), 16 keys a slice

  // S = Q K^T of tile j into s, as one commit group
  auto issue_s = [&](float (&s)[32], int j) {
    const int st = j % STAGES;
    mbar_wait(full0 + 8 * st, (j / STAGES) & 1);
    const uint32_t sk = base + L::K + st * 2 * L::tile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<DT>(s, sw_k(sq, 64, kk), sw_k(sk, 64, kk), kk > 0);
    wgmma_commit();
  };

  // the softmax of tile j: x = S scale log2(e) (-1e30 where masked), the
  // new running max, corr = exp2(m_old - m_new) and P = exp2(x - m_new)
  // into sc, and l = l corr + rowsum(P)
  auto softmax = [&](float (&sc)[32], int j, float (&corr)[2]) {
    const int k0 = j * 64;
    float mx[2] = {kNegInf, kNegInf};
    // a tile with no masked pair takes the loop without mask tests, one
    // masked only by the valid length a loop with a test a key
    if (k0 + 64 <= kvlen && p.qseg == nullptr &&
        (!p.causal || q0 >= k0 + 63)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] *= c;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
    } else if (!p.causal && p.qseg == nullptr) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        sc[i] = key < kvlen ? sc[i] * c : kNegInf;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        sc[i] = visible(p, b, kvlen, row0 + 8 * ((i >> 1) & 1), key)
                    ? sc[i] * c
                    : kNegInf;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
    }
    // the new row max over the row's four threads; a row that has seen no
    // key yet subtracts 0, so its masked entries give exp2(-1e30) = 0
    float sub[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      sub[h] = m_new == kNegInf ? 0.f : m_new;
      corr[h] = fast_exp2(m[h] - sub[h]);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = fast_exp2(sc[i] - sub[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }
  };
  // O = O corr + bf16(P) V of tile j, as one commit group
  auto issue_pv = [&](int j, const float (&corr)[2]) {
#pragma unroll
    for (int h = 0; h < D / 64; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[h][i] *= corr[(i >> 1) & 1];
    const uint32_t sv = base + L::K + (j % STAGES) * 2 * L::tile + L::tile;
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) fence_regs(o[h]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        wgmma_rs<DT>(o[h], pf[kk], sw_mn(sv + h * 64 * 128, kk));
    wgmma_commit();
  };

  // Tile 0's softmax, then per tile j > 0: S_j and P V of tile j - 1 in
  // flight together, tile j's softmax under P V_{j-1}; every group is done
  // by the end of the iteration, so that ptxas sees no accumulator in
  // flight across the loop's edges (it serialises the products where it
  // cannot tell that one is not touched before its group ends)
  float corr[2] = {1.f, 1.f};
  if (n_tiles > 0) {
    mbar_wait(qbar, 0);
    float s0[32];
    issue_s(s0, 0);
    wgmma_wait<0>();
    fence_regs(s0);
    softmax(s0, 0, corr);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      acc_to_a<DT>(pf[kk], &s0[8 * kk], &s0[8 * kk + 4]);
  }
  for (int j = 1; j < n_tiles; ++j) {
    float sc[32];
    issue_s(sc, j);
    issue_pv(j - 1, corr);
    refill(j - 2);
    wgmma_wait<1>();                         // S_j is done
    fence_regs(sc);
    softmax(sc, j, corr);
    wgmma_wait<0>();                         // P V_{j-1} is done
#pragma unroll
    for (int h = 0; h < D / 64; ++h) fence_regs(o[h]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * ((j - 1) % STAGES));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      acc_to_a<DT>(pf[kk], &sc[8 * kk], &sc[8 * kk + 4]);
  }
  if (n_tiles > 0) {
    issue_pv(n_tiles - 1, corr);
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) fence_regs(o[h]);
  }

  // O = acc / l rounded once to bf16, written into the Q buffer as the
  // 128-byte swizzle lays it out (16-byte chunk c of row r at c ^ (r % 8),
  // and r % 8 = g) and stored by TMA; a row that sees no key gives o = 0
  // and lse = 0
  __syncthreads();                           // every read of Q is done
  unsigned char* so = sbase + L::Q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float den = l[h] > 0.f ? l[h] : 1.f;
    const int r = warp * 16 + g + 8 * h;
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(so + hh * 64 * 128 + r * 128 +
                                     ((j ^ g) << 4) + 4 * t) =
            pack2<DT>(o[hh][4 * j + 2 * h] / den,
                      o[hh][4 * j + 2 * h + 1] / den);
    const int row = row0 + 8 * h;
    if (t == 0 && row < p.Tq)
      p.lse[(size_t)bh * p.Tq + row] =
          l[h] > 0.f ? m[h] * kLn2 + logf(l[h]) : 0.f;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0 && q0 < p.Tq) {
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh)
      tma_store_4d(&hf.to, sq + hh * 64 * 128, hh * 64, q0, hd, b);
    tma_store_wait();
  }
}

// ---- the bf16 backward ------------------------------------------------------

// the operands of the bf16 backward kernels: 4-d tensor maps (D, T, H, B)
// of q, k, v and dO over their strides, boxes of 64 columns by the
// kernel's tile rows of one head
struct HopperBwd {
  CUtensorMap tq, tk, tv, tdo;
  BwdParams p;
  // delta and lse * log2(e), BH x tq_pad each, 0 past Tq: written by the
  // dQ kernel, read by the dK/dV kernel launched after it
  float* delta;
  float* lse2;
  int tq_pad;          // Tq rounded up to 64
  float scale_log2;    // scale * log2(e)
};

// shared memory of flash_bwd_kv_hopper, byte offsets from a 1024-byte
// aligned base: K and V (64 x D), then STAGES x (Q, dO) tiles of BR x D,
// then STAGES x (lse2, delta) of BR floats
template <int D, int BR, int STAGES>
struct KvSmem {
  static constexpr int kTile = 64 * D * 2;
  static constexpr int qTile = BR * D * 2;
  static constexpr int K = 0;
  static constexpr int V = kTile;
  static constexpr int Q = 2 * kTile;                  // + s * 2 qTile
  static constexpr int LSE = Q + STAGES * 2 * qTile;   // + s * 2 BR * 4
  static constexpr int BYTES = LSE + STAGES * 2 * BR * 4;
};

// dK and dV of one 64-key tile.  Per Q tile: S^T = K Q^T and dP^T = V dO^T
// (keys x queries), P^T = exp2(S^T scale log2 e - lse2) (0 where masked),
// dS^T = P^T (dP^T - delta) scale, then dV += bf16(P^T) dO and dK +=
// bf16(dS^T) Q.  Accumulator element 4 j + i of a thread: key key0 +
// 8 (i >> 1), query q0 + 8 j + 2 t + (i & 1).
template <int DT, int D, int BR, int STAGES, int MINB, int DOUT>
__global__ void __launch_bounds__(128, MINB)
flash_bwd_kv_hopper(const __grid_constant__ HopperBwd hp) {
  typedef typename Elem<DT>::T T;
  using L = KvSmem<D, BR, STAGES>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* sbase = smem_raw + (base - raw);
  const BwdParams& p = hp.p;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the DOUT output columns c0 .. c0 + DOUT - 1 of the key tile k0
  const int tile = blockIdx.x / (D / DOUT);
  const int c0 = (blockIdx.x % (D / DOUT)) * DOUT;
  const int bh = tile / p.n_ktiles;
  const int k0 = (tile % p.n_ktiles) * 64;
  const int b = bh / p.H, hd = bh % p.H;
  const int kvlen = valid_keys(p, b);
  const int it0 = first_query_tile(p, k0, BR);
  // keys at or past the valid length see nothing: dK = dV = 0
  const int it_end = k0 < kvlen ? (p.Tq + BR - 1) / BR : 0;
  const uint32_t full0 = smem_addr(&bars[0]);
  const uint32_t empty0 = smem_addr(&bars[STAGES]);
  const uint32_t kvbar = smem_addr(&bars[2 * STAGES]);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);    // one arrival per consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues the loads: K, V and the first STAGES Q/dO tiles here,
  // each later tile in refill below
  const int n_tiles = it_end - it0;
  auto load_tile = [&](int n) {
    const int s = n % STAGES, it = it0 + n;
    const uint32_t fb = full0 + 8 * s;
    mbar_expect_tx(fb, 2 * L::qTile + 2 * BR * 4);
    const uint32_t sq = base + L::Q + s * 2 * L::qTile;
#pragma unroll
    for (int h = 0; h < D / 64; ++h) {
      tma_load_4d(sq + h * BR * 128, &hp.tq, fb, h * 64, it * BR, hd, b);
      tma_load_4d(sq + L::qTile + h * BR * 128, &hp.tdo, fb, h * 64, it * BR,
                  hd, b);
    }
    const size_t row = (size_t)bh * hp.tq_pad + (size_t)it * BR;
    const uint32_t sl = base + L::LSE + s * 2 * BR * 4;
    bulk_load(sl, hp.lse2 + row, BR * 4, fb);
    bulk_load(sl + BR * 4, hp.delta + row, BR * 4, fb);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(kvbar, 2 * L::kTile);
#pragma unroll
    for (int h = 0; h < D / 64; ++h) {
      tma_load_4d(base + L::K + h * 64 * 128, &hp.tk, kvbar, h * 64, k0, hd,
                  b);
      tma_load_4d(base + L::V + h * 64 * 128, &hp.tv, kvbar, h * 64, k0, hd,
                  b);
    }
    for (int n = 0; n < n_tiles && n < STAGES; ++n) load_tile(n);
  }

  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g;   // this thread's keys: key0, +8
  float dk[DOUT / 64][32], dv[DOUT / 64][32];    // by 64-column half
#pragma unroll
  for (int h = 0; h < DOUT / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[h][i] = dv[h][i] = 0.f;
  // While the tensor cores run tile n's first products, thread 0 refills
  // the buffer released one tile earlier (its four arrivals are in: every
  // warp has issued tile n's wgmma) with tile n - 1 + STAGES
  auto refill = [&](int m) {
    if (tid == 0 && m >= 0 && m + STAGES < n_tiles) {
      mbar_wait(empty0 + 8 * (m % STAGES), (m / STAGES) & 1);
      load_tile(m + STAGES);
    }
  };
  if (n_tiles > 0) mbar_wait(kvbar, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % STAGES;
    const int q0 = (it0 + n) * BR;
    const uint32_t sq = base + L::Q + s * 2 * L::qTile;
    const uint32_t sdo = sq + L::qTile;
    const float* slse =
        reinterpret_cast<const float*>(sbase + L::LSE + s * 2 * BR * 4);
    const float* sdl = slse + BR;
    mbar_wait(full0 + 8 * s, (n / STAGES) & 1);

    // S^T and dP^T as two groups: P^T is computed while dP^T is still on
    // the tensor cores
    float st[BR / 2], dpt[BR / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<DT>(st, sw_k(base + L::K, 64, kk), sw_k(sq, BR, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<DT>(dpt, sw_k(base + L::V, 64, kk), sw_k(sdo, BR, kk), kk > 0);
    wgmma_commit();
    refill(n - 1);
    wgmma_wait<1>();
    fence_regs(st);

    // P^T; a tile with no masked pair takes the loop without mask tests,
    // one masked only by the valid length and Tq a loop with a test a key
    // and a query
    if (tile_unmasked<BR>(p, kvlen, q0, k0)) {
#pragma unroll
      for (int j = 0; j < BR / 8; ++j) {
        // lse2 of queries 8 j + 2 t and + 1
        const float2 l2 =
            *reinterpret_cast<const float2*>(slse + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          st[4 * j + i] = fast_exp2(st[4 * j + i] * hp.scale_log2 -
                                    ((i & 1) ? l2.y : l2.x));
      }
    } else if (!p.causal && p.qseg == nullptr) {
      const bool key_in[2] = {key0 < kvlen, key0 + 8 < kvlen};
#pragma unroll
      for (int j = 0; j < BR / 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(slse + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = 8 * j + 2 * t + (i & 1);
          st[4 * j + i] =
              key_in[i >> 1] && q0 + qc < p.Tq
                  ? fast_exp2(st[4 * j + i] * hp.scale_log2 -
                              ((i & 1) ? l2.y : l2.x))
                  : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BR / 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(slse + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = 8 * j + 2 * t + (i & 1);
          st[4 * j + i] =
              visible(p, b, kvlen, q0 + qc, key0 + (i >> 1) * 8)
                  ? fast_exp2(st[4 * j + i] * hp.scale_log2 -
                              ((i & 1) ? l2.y : l2.x))
                  : 0.f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dpt);
    // dS^T, and P^T and dS^T rounded to bf16 as the A fragments of dV and
    // dK, 16 queries at a time
    uint32_t pf[BR / 16][4], dsf[BR / 16][4];
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
#pragma unroll
      for (int j = 2 * kk; j < 2 * kk + 2; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(sdl + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dpt[4 * j + i] = st[4 * j + i] *
                           (dpt[4 * j + i] - ((i & 1) ? dl.y : dl.x)) * p.scale;
      }
      acc_to_a<DT>(pf[kk], &st[8 * kk], &st[8 * kk + 4]);
      acc_to_a<DT>(dsf[kk], &dpt[8 * kk], &dpt[8 * kk + 4]);
    }
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < DOUT / 64; ++h) {
      fence_regs(dv[h]);
      fence_regs(dk[h]);
    }
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
      for (int h = 0; h < DOUT / 64; ++h) {
        const int half = c0 / 64 + h;
        wgmma_rs<DT>(dv[h], pf[kk], sw_mn(sdo + half * BR * 128, kk));
        wgmma_rs<DT>(dk[h], dsf[kk], sw_mn(sq + half * BR * 128, kk));
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < DOUT / 64; ++h) {
      fence_regs(dv[h]);
      fence_regs(dk[h]);
    }
    // this tile's buffer is free once all four warps arrive
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  T* dkp = head_ptr(static_cast<T*>(p.dk), p.sdk, b, hd);
  T* dvp = head_ptr(static_cast<T*>(p.dv), p.sdv, b, hd);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + h * 8;
    if (key >= p.Tk) continue;
    T* dkr = dkp + (size_t)key * p.sdk.t + c0 + 2 * t;
    T* dvr = dvp + (size_t)key * p.sdv.t + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DOUT / 8; ++dt) {
      const float* k2 = &dk[dt >> 3][4 * (dt & 7) + 2 * h];
      const float* v2 = &dv[dt >> 3][4 * (dt & 7) + 2 * h];
      *reinterpret_cast<uint32_t*>(dkr + dt * 8) = pack2<DT>(k2[0], k2[1]);
      *reinterpret_cast<uint32_t*>(dvr + dt * 8) = pack2<DT>(v2[0], v2[1]);
    }
  }
}

// shared memory of flash_bwd_q_hopper: Q and dO (64 x D), then STAGES x
// (K, V) tiles of 64 x D
template <int D, int STAGES>
struct QSmem {
  static constexpr int tile = 64 * D * 2;
  static constexpr int Q = 0;
  static constexpr int DO = tile;
  static constexpr int K = 2 * tile;                   // + s * 2 tile
  static constexpr int BYTES = K + STAGES * 2 * tile;
};

// dQ of one 64-query tile.  Per K tile: S = Q K^T and dP = dO V^T, P =
// exp2(S scale log2 e - lse2) (0 where masked), dS = P (dP - delta) scale,
// dQ += bf16(dS) K.  Accumulator element 4 j + i of a thread: row row0 +
// 8 (i >> 1), key k0 + 8 j + 2 t + (i & 1).
template <int DT, int D, int STAGES, int MINB, int DOUT>
__global__ void __launch_bounds__(128, MINB)
flash_bwd_q_hopper(const __grid_constant__ HopperBwd hp) {
  typedef typename Elem<DT>::T T;
  using L = QSmem<D, STAGES>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const BwdParams& p = hp.p;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the DOUT output columns c0 .. c0 + DOUT - 1 of the query tile q0
  const int tile = blockIdx.x / (D / DOUT);
  const int c0 = (blockIdx.x % (D / DOUT)) * DOUT;
  const int bh = tile / p.n_qtiles;
  const int q0 = (tile % p.n_qtiles) * 64;
  const int b = bh / p.H, hd = bh % p.H;
  const int kvlen = valid_keys(p, b);
  const int n_tiles = key_tiles(p, kvlen, q0);
  const uint32_t full0 = smem_addr(&bars[0]);
  const uint32_t empty0 = smem_addr(&bars[STAGES]);
  const uint32_t qbar = smem_addr(&bars[2 * STAGES]);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues the loads: Q, dO and the first STAGES K/V tiles here,
  // each later tile in refill below
  auto load_tile = [&](int it) {
    const int s = it % STAGES;
    const uint32_t fb = full0 + 8 * s;
    mbar_expect_tx(fb, 2 * L::tile);
    const uint32_t sk = base + L::K + s * 2 * L::tile;
#pragma unroll
    for (int h = 0; h < D / 64; ++h) {
      tma_load_4d(sk + h * 64 * 128, &hp.tk, fb, h * 64, it * 64, hd, b);
      tma_load_4d(sk + L::tile + h * 64 * 128, &hp.tv, fb, h * 64, it * 64,
                  hd, b);
    }
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(qbar, 2 * L::tile);
#pragma unroll
    for (int h = 0; h < D / 64; ++h) {
      tma_load_4d(base + L::Q + h * 64 * 128, &hp.tq, qbar, h * 64, q0, hd,
                  b);
      tma_load_4d(base + L::DO + h * 64 * 128, &hp.tdo, qbar, h * 64, q0, hd,
                  b);
    }
    for (int it = 0; it < n_tiles && it < STAGES; ++it) load_tile(it);
  }

  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;     // this thread's rows: row0, +8

  // delta = rowsum(dO * O) of the block's 64 rows, two threads a row,
  // while the first tiles load; with lse * log2(e) the first column slice
  // writes it to the padded arrays (0 past Tq) that the dK/dV kernel,
  // launched next, reads
  __shared__ float s_delta[64];
  {
    const int r = tid >> 1, row = q0 + r;
    float sum = 0.f;
    if (row < p.Tq) {
      const int c0 = (tid & 1) * (D / 2);
      const uint4* o4 = reinterpret_cast<const uint4*>(
          head_ptr(static_cast<const T*>(p.o), p.so, b, hd) +
          (size_t)row * p.so.t + c0);
      const uint4* d4 = reinterpret_cast<const uint4*>(
          head_ptr(static_cast<const T*>(p.dout), p.sdo, b, hd) +
          (size_t)row * p.sdo.t + c0);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 ov = o4[c], dv = d4[c];
        const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
        const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a = unpack2<DT>(ow[i]);
          const float2 e = unpack2<DT>(dw[i]);
          sum += a.x * e.x + a.y * e.y;
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((tid & 1) == 0) s_delta[r] = sum;
    if ((tid & 1) == 0 && c0 == 0) {
      const size_t at = (size_t)bh * hp.tq_pad + row;
      hp.delta[at] = sum;
      hp.lse2[at] =
          row < p.Tq ? p.lse[(size_t)bh * p.Tq + row] * kLog2e : 0.f;
    }
  }
  __syncthreads();
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    lse_r[h] = row < p.Tq ? p.lse[(size_t)bh * p.Tq + row] * kLog2e : 0.f;
    dl_r[h] = s_delta[row - q0];
  }
  float dq[DOUT / 64][32];                 // by 64-column half
#pragma unroll
  for (int h = 0; h < DOUT / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[h][i] = 0.f;
  // buffers released and refilled as in flash_bwd_kv_hopper
  auto refill = [&](int m) {
    if (tid == 0 && m >= 0 && m + STAGES < n_tiles) {
      mbar_wait(empty0 + 8 * (m % STAGES), (m / STAGES) & 1);
      load_tile(m + STAGES);
    }
  };
  if (n_tiles > 0) mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int k0 = it * 64;
    const uint32_t sk = base + L::K + s * 2 * L::tile;
    const uint32_t sv = sk + L::tile;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);

    // S and dP as two groups: P is computed while dP is on the tensor cores
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<DT>(sc, sw_k(base + L::Q, 64, kk), sw_k(sk, 64, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<DT>(dp, sw_k(base + L::DO, 64, kk), sw_k(sv, 64, kk), kk > 0);
    wgmma_commit();
    refill(it - 1);
    wgmma_wait<1>();
    fence_regs(sc);

    // P; a tile with no masked pair takes the loop without mask tests,
    // one masked only by the valid length and Tq a loop with a test a key
    // and a query
    if (tile_unmasked(p, kvlen, q0, k0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] = fast_exp2(sc[i] * hp.scale_log2 - lse_r[(i >> 1) & 1]);
    } else if (!p.causal && p.qseg == nullptr) {
      const bool row_in[2] = {row0 < p.Tq, row0 + 8 < p.Tq};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          sc[4 * j + i] =
              row_in[h] && k0 + 8 * j + 2 * t + (i & 1) < kvlen
                  ? fast_exp2(sc[4 * j + i] * hp.scale_log2 - lse_r[h])
                  : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          sc[4 * j + i] =
              visible(p, b, kvlen, row0 + h * 8, k0 + 8 * j + 2 * t + (i & 1))
                  ? fast_exp2(sc[4 * j + i] * hp.scale_log2 - lse_r[h])
                  : 0.f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS, rounded to bf16 as the A fragments of dQ, 16 keys at a time
    uint32_t dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 8 * kk; i < 8 * kk + 8; ++i)
        dp[i] = sc[i] * (dp[i] - dl_r[(i >> 1) & 1]) * p.scale;
      acc_to_a<DT>(dsf[kk], &dp[8 * kk], &dp[8 * kk + 4]);
    }
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < DOUT / 64; ++h) fence_regs(dq[h]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < DOUT / 64; ++h)
        wgmma_rs<DT>(dq[h], dsf[kk],
                     sw_mn(sk + (c0 / 64 + h) * 64 * 128, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < DOUT / 64; ++h) fence_regs(dq[h]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  T* dqp = head_ptr(static_cast<T*>(p.dq), p.sdq, b, hd);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    if (row >= p.Tq) continue;
    T* dqr = dqp + (size_t)row * p.sdq.t + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DOUT / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dqr + dt * 8) =
          pack2<DT>(dq[dt >> 3][4 * (dt & 7) + 2 * h],
                    dq[dt >> 3][4 * (dt & 7) + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// float32: three TF32 products on mma.sync
// ---------------------------------------------------------------------------
//
// The float32 forward (flash_fwd_tf32) and backward (flash_bwd_q_tf32,
// flash_bwd_kv_tf32) replace the same TPU kernels as the 16-bit ones above
// (_fwd_kernel_single and _fwd_kernel; _dqkv_single_kernel,
// _dqkv_fused_kernel, _dq_kernel and _dkv_kernel) in float32, for both
// entries and every mask, with the 16-bit designs' split: a forward block
// of 64 query rows streaming K/V tiles; a dQ block of 64 query rows
// streaming K/V tiles, which also writes delta and lse * log2(e) for the
// dK/dV block of 64 keys streaming Q/dO tiles, launched after it.  No
// atomics: a second run gives the same bits.
//
// What bounds them.  Float32 FMAs peak at 67 TFLOP/s on this card; the
// tensor cores take TF32 (8-bit exponent, 10 stored mantissa bits) at 495
// TFLOP/s dense.  One TF32 product keeps 11 significant bits, too few for
// float32 (every check of the port runs with TF32 off).  So each operand x
// is split into big = tf32(x), rounded to nearest with ties away from zero,
// and small = x - big, and each float32 product a b becomes small_a big_b
// + big_a small_b + big_a big_b (mma3 below: the two small terms first),
// summed in fp32 by the tensor cores.  big + small holds about 22 of x's
// 24 bits; the dropped small_a small_b is below 2^-22 of the product, so a
// product is good to about 5e-7 relative, well inside the float32 checks
// (o 2e-5 and lse 1e-5 absolute, gradients 1e-5 of the largest).  Three
// TF32 products at 495 TFLOP/s are 165 TFLOP/s of float32 work, 2.5x the
// FFMA peak.  The earlier scalar-FMA kernels were bound by shared memory
// (8 loads for 16 FMAs), one block an SM and synchronous staging; these
// feed each 4-byte load into 16 to 64 multiply-adds of an m16n8k8 product.
//
// What the measurements on an H100 changed (chip_diag.py fwd and bwd, each
// version against the others in turns):
// - The split, not the products, is the cost: with the operands' bits
//   passed unsplit (wrong results, three products kept) the kernels ran
//   1.8-1.9x faster.  cvt.rna.tf32.f32 is a conversion instruction, far
//   slower than integer or fp32 ones, so big is computed as cvt.rna
//   rounds it but on the integer pipe (half a TF32 ulp added to the bit
//   pattern, the low 13 bits cleared), and small is passed as its fp32
//   bits, which the tensor core reads as TF32 (its top 19 bits: small
//   truncated, about 2^-22 of x).  The same errors, and 1.4-1.5x the
//   speed of two cvt.rna.  A big truncated too was 1.1x faster again but
//   doubled the backward's error (9.5e-6 of the 1e-5 check at T 1024).
// - The tensor cores' fp32 sums truncate: chained over a 1024-key row,
//   dq read 1.48e-5 of its largest value.  So each streamed tile's
//   products (P V, dS K, P^T dO, dS^T Q) start from 0 on the tensor cores
//   and are added to the running O (with its rescaling, one fmaf), dQ, dK
//   or dV in fp32: 6.0e-6 at T 1024.  Likewise S and dP (S^T, dP^T) are
//   summed in chunks of 64 dims: chained over D 256, a gradient read
//   1.03e-5 of its largest.
//
// Why mma.sync (m16n8k8, TF32 in, fp32 accumulate) and not wgmma: a TF32
// wgmma reads shared-memory operands K-major only, and several products
// here need the other order (V in O += P V; K, Q and dO in the backward),
// which TMA cannot transpose.  With mma.sync each lane loads its own
// fragment from any layout.
//
// Fragments (g = lane / 4, t = lane % 4): A (16 x 8) a0..a3 at (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8) b0, b1 at (k = t, n =
// g) and (t + 4, g); C (16 x 8) c0..c3 at (g, 2t), (g, 2t + 1), (g + 8,
// 2t), (g + 8, 2t + 1).  A warp owns 16 rows of the block's resident tile,
// so its accumulators hold whole rows: the softmax's row max and sum need
// only the shuffles among a row's four lanes.
//
// P and dS stay in registers.  In lane (g, t) the accumulator of S's n-tile
// j holds keys 8j + 2t and 8j + 2t + 1; the next product sums over keys, so
// its A fragment takes key 8j + 2t as k = t and 8j + 2t + 1 as k = t + 4
// (acc_a), and its B operand loads its key rows in that order (load_b_n:
// row 2t as k = t, row 2t + 1 as k = t + 4).  P V, dS K, P^T dO and dS^T Q
// run straight from the accumulators, with no shuffle and no trip through
// shared memory.
//
// Staging.  Tiles go into shared memory with rows of LD = D + 4 floats
// (DOUT + 4 for a column slice of V), by 16-byte cp.async, rows past T
// zero-filled through the copy's source size; a ring of two stages of the
// streamed tiles, so the next tile's copies run under this tile's
// products.  LD keeps each row 16-byte aligned, and since LD = 4 (mod 32)
// every fragment load is free of bank conflicts: row-major A (Q, dO, K, V
// as the resident operand) and K-major B (K, V, Q, dO as the streamed
// operand of S, dP, S^T, dP^T) read [r + g][c + t] and [r + g][c + t + 4],
// bank 4g + t (+ 4) mod 32, the 32 lanes on 32 banks; N-major B (V for P V,
// K for dS K, dO for P^T dO, Q for dS^T Q) reads [k + 2t][n + g] and
// [k + 2t + 1][n + g], bank 8t + g (+ 4) mod 32, 32 banks again.
//
// The softmax is online, in fp32 on the accumulator fragments, with exp2
// on the special-function unit (ex2.approx) and log2(e) folded into the
// scale; a tile with no masked pair skips the mask tests, one masked only
// by lengths tests each key (and query), and causal and segment tiles test
// each element, as in the 16-bit kernels.
//
// Tiles (F32Tiles below; 4 warps, 128 threads a block; a 16-row warp tile
// of an N-column product holds N / 2 fp32 accumulators a thread).  The
// forward's K/V tiles take 64 keys at D 64 and 32 above; above D 128 O is
// split into column slices of 96 (D 192) or 64 (D 256), each a block that
// recomputes S over the whole D.  The dQ kernel streams 64 keys at D 64
// and 16 above (Q and dO resident), in slices of 96 and 64 above D 128;
// the dK/dV kernel 32 queries at D 64, 8 at D 128 (dK and dV take 128
// registers a thread; with 16 the kernel spilled, and 8 cost 6%) and 16
// above (K and V resident), and above D 128 each block accumulates a
// 64-column slice of dK and dV (DOUT), as the 16-bit backward does (a
// slice at D 128 cost 25%).  Shared memory (the resident tiles and two
// stages): forward 87,040 bytes at D 64 and 101,376 at D 128 (two blocks
// an SM), 125,952 and 150,528 at D 192 and 256; dQ 104,448, 101,376,
// 150,528 and 199,680; dK/dV 70,144, 84,608, 150,784 and 199,936.  No
// kernel spills (chip_smoke.py prints ptxas's registers and fails on a
// spill); the unrolled loops are bounded where a whole unroll's hoisted
// loads or staging addresses would not fit 255 registers.

// x split into big = tf32(x), rounded to nearest with ties away from zero
// (cvt.rna.tf32.f32's result, computed on the integer pipe: half a TF32
// ulp added to the bit pattern, the low 13 bits cleared), and small = x -
// big, exact in fp32, whose bits the tensor core reads as TF32 (its top 19
// bits: small truncated)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// an m16n8k8 A fragment (four values a lane) and B fragment (two), split
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// d += a b on the tensor cores, TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b to about float32 accuracy: the two small terms, then big big
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// the A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 7 of a
// row-major tile of row stride LD
template <int LD>
__device__ __forceinline__ void load_a(FragA& f, const float* tile, int r0,
                                       int k0, int g, int t) {
  const float* x = tile + (r0 + g) * LD + k0 + t;
  split_tf32(x[0], f.big[0], f.small[0]);
  split_tf32(x[8 * LD], f.big[1], f.small[1]);
  split_tf32(x[4], f.big[2], f.small[2]);
  split_tf32(x[8 * LD + 4], f.big[3], f.small[3]);
}

// the B fragment (k0 .. k0 + 7 by n0 .. n0 + 7) of a K-major tile: row n,
// column k (K in S = Q K^T)
template <int LD>
__device__ __forceinline__ void load_b_k(FragB& f, const float* tile, int n0,
                                         int k0, int g, int t) {
  const float* x = tile + (n0 + g) * LD + k0 + t;
  split_tf32(x[0], f.big[0], f.small[0]);
  split_tf32(x[4], f.big[1], f.small[1]);
}

// the B fragment of an N-major tile: row k, column n (V in O = P V), its
// rows in acc_a's order: k = t is row k0 + 2t, k = t + 4 row k0 + 2t + 1
template <int LD>
__device__ __forceinline__ void load_b_n(FragB& f, const float* tile, int k0,
                                         int n0, int g, int t) {
  const float* x = tile + (k0 + 2 * t) * LD + n0 + g;
  split_tf32(x[0], f.big[0], f.small[0]);
  split_tf32(x[LD], f.big[1], f.small[1]);
}

// acc += part, element by element in fp32
template <int N>
__device__ __forceinline__ void add_acc(float (&acc)[N][4],
                                        const float (&part)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
}

// the accumulator of an n-tile (columns 2t and 2t + 1 of rows g and g + 8
// in lane (g, t)) as the A fragment of the next product over its columns:
// column 2t is k = t, column 2t + 1 is k = t + 4
__device__ __forceinline__ void acc_a(FragA& f, const float (&c)[4]) {
  split_tf32(c[0], f.big[0], f.small[0]);
  split_tf32(c[2], f.big[1], f.small[1]);
  split_tf32(c[1], f.big[2], f.small[2]);
  split_tf32(c[3], f.big[3], f.small[3]);
}

// 16 bytes from global memory into shared memory, asynchronously; `bytes`
// 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread's copies are
// pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0 + R - 1, columns c0 .. c0 + C - 1 of a float operand whose
// rows lie `ld` elements apart from `src` (row 0 of one head) into `dst`
// with row stride LD, by the block's 128 threads; rows at or past `rows`
// are zero-filled (a source size of 0, pointed at row 0)
template <int R, int C, int LD>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           long long ld, int r0, int rows,
                                           int c0, int tid) {
  constexpr int CH = C / 4;                 // 16-byte chunks a row
  static_assert((R * CH) % 128 == 0, "whole chunks a thread");
  // unrolled by 4, not whole: a whole unroll computes every address first
  // (64 pointers a thread for a 64 x 256 tile) and spills
#pragma unroll 4
  for (int j = 0; j < R * CH / 128; ++j) {
    const int i = tid + 128 * j;
    const int r = i / CH, c = (i % CH) * 4;
    const bool in = r0 + r < rows;
    cp_async16(dst + r * LD + c,
               src + (in ? (size_t)(r0 + r) * ld + c0 + c : 0), in ? 16 : 0);
  }
}

// The tiles of the float32 kernels at head dim D (the reasons are in the
// note above).  FWD_K: keys a K/V tile of the forward; FWD_DOUT: the output
// columns of a forward block; Q_K: keys a K/V tile of the dQ kernel; Q_DOUT:
// the dQ columns of a block; KV_R: queries a Q/dO tile of the dK/dV
// kernel; KV_DOUT: the dK and dV columns of a block; *_MINB: blocks an SM
// each kernel is compiled for (at most 255 registers a thread for 1 and 2).
template <int D>
struct F32Tiles;
template <>
struct F32Tiles<64> {
  static constexpr int FWD_K = 64, FWD_DOUT = 64, FWD_MINB = 2;
  static constexpr int Q_K = 64, Q_DOUT = 64, Q_MINB = 2;
  static constexpr int KV_R = 32, KV_DOUT = 64, KV_MINB = 2;
};
template <>
struct F32Tiles<128> {
  static constexpr int FWD_K = 32, FWD_DOUT = 128, FWD_MINB = 2;
  static constexpr int Q_K = 16, Q_DOUT = 128, Q_MINB = 2;
  static constexpr int KV_R = 8, KV_DOUT = 128, KV_MINB = 2;
};
template <>
struct F32Tiles<192> {
  static constexpr int FWD_K = 32, FWD_DOUT = 96, FWD_MINB = 1;
  static constexpr int Q_K = 16, Q_DOUT = 96, Q_MINB = 1;
  static constexpr int KV_R = 16, KV_DOUT = 64, KV_MINB = 1;
};
template <>
struct F32Tiles<256> {
  static constexpr int FWD_K = 32, FWD_DOUT = 64, FWD_MINB = 1;
  static constexpr int Q_K = 16, Q_DOUT = 64, Q_MINB = 1;
  static constexpr int KV_R = 16, KV_DOUT = 64, KV_MINB = 1;
};

// shared memory of flash_fwd_tf32, in floats: the Q tile (64 x LQ), then
// two stages of a K tile (KT x LQ) and a V column slice (KT x LV)
template <int D, int KT, int DOUT>
struct FwdF32Smem {
  static constexpr int LQ = D + 4, LV = DOUT + 4;
  static constexpr int KV = 64 * LQ;                   // + s * STAGE
  static constexpr int V = KT * LQ;                    // within a stage
  static constexpr int STAGE = KT * LQ + KT * LV;
  static constexpr size_t BYTES = (size_t)(KV + 2 * STAGE) * sizeof(float);
};

// o and lse of the 64 query rows q0 .. q0 + 63 in float32, output columns
// c0 .. c0 + DOUT - 1 (D / DOUT blocks a tile, each computing S whole).
// Per K tile of KT keys: S = Q K^T, x = S scale log2(e) (-1e30 where
// masked), the running row max m (in those units) and sum l, P = exp2(x -
// m), O = O exp2(m_old - m) + P V, every product as three TF32 products.
// Accumulator element [j][i] of a thread: row row0 + 8 (i >> 1), key (or
// column) 8 j + 2 t + (i & 1).
template <int D, int KT, int DOUT, int MINB>
__global__ void __launch_bounds__(128, MINB)
flash_fwd_tf32(const StridedParams p, float scale_log2) {
  using L = FwdF32Smem<D, KT, DOUT>;
  constexpr int LQ = L::LQ, LV = L::LV, NT = KT / 8, NO = DOUT / 8;
  // S's 64-dim chunks and their k-steps unrolled: all up to D 128; above,
  // one chunk at a time, four k-steps, so that the loads hoisted ahead of
  // the products do not exhaust the registers
  constexpr int KC = D <= 128 ? D / 64 : 1, KU = D <= 128 ? 8 : 4;
  extern __shared__ __align__(16) float smf[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x / (D / DOUT);
  const int c0 = (blockIdx.x % (D / DOUT)) * DOUT;
  const int bh = tile / p.n_qtiles;
  const int q0 = (tile % p.n_qtiles) * 64;
  const int b = bh / p.H, hd = bh % p.H;
  const float* q = head_ptr(static_cast<const float*>(p.q), p.sq, b, hd);
  const float* k = head_ptr(static_cast<const float*>(p.k), p.sk, b, hd);
  const float* v = head_ptr(static_cast<const float*>(p.v), p.sv, b, hd);
  const int kvlen = valid_keys(p, b);
  const int n_tiles = key_tiles<64, KT>(p, kvlen, q0);
  const float* sq = smf;

  auto stage_kv = [&](int j) {
    float* sk = smf + L::KV + (j & 1) * L::STAGE;
    stage_tile<KT, D, LQ>(sk, k, p.sk.t, j * KT, p.Tk, 0, tid);
    stage_tile<KT, DOUT, LV>(sk + L::V, v, p.sv.t, j * KT, p.Tk, c0, tid);
  };
  if (n_tiles > 0) {
    stage_tile<64, D, LQ>(smf, q, p.sq.t, q0, p.Tq, 0, tid);
    stage_kv(0);
  }
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;      // this thread's rows: row0, +8
  const float c = scale_log2;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};                  // this thread's share of the sum
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // tile j + 1's copies go out under tile j's products
    if (j + 1 < n_tiles) {
      stage_kv(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sk = smf + L::KV + (j & 1) * L::STAGE;
    const float* sv = sk + L::V;
    const int k0 = j * KT;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    // S in chunks of 64 dims, each summed from 0 on the tensor cores and
    // added in fp32 (their own sums truncate: a chain over the whole D read
    // 1.03e-5 of the largest gradient at D 256)
#pragma unroll KC
    for (int ch = 0; ch < D / 64; ++ch) {
      float sc[NT][4] = {};
#pragma unroll KU
      for (int kk = 8 * ch; kk < 8 * ch + 8; ++kk) {
        FragA a;
        load_a<LQ>(a, sq, warp * 16, kk * 8, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          FragB bk;
          load_b_k<LQ>(bk, sk, n * 8, kk * 8, g, t);
          mma3(sc[n], a, bk);
        }
      }
      add_acc(s, sc);
    }

    // the softmax: a tile with no masked pair takes the loop without mask
    // tests, one masked only by the valid length a loop with a test a key
    float mx[2] = {kNegInf, kNegInf};
    if (k0 + KT <= kvlen && p.qseg == nullptr &&
        (!p.causal || q0 >= k0 + KT - 1)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] *= c;
          mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
        }
    } else if (!p.causal && p.qseg == nullptr) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 8 * n + 2 * t + (i & 1);
          s[n][i] = key < kvlen ? s[n][i] * c : kNegInf;
          mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
        }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 8 * n + 2 * t + (i & 1);
          s[n][i] = visible(p, b, kvlen, row0 + 8 * (i >> 1), key)
                        ? s[n][i] * c
                        : kNegInf;
          mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
        }
    }
    // the new row max over the row's four lanes; a row that has seen no
    // key yet subtracts 0, so its masked entries give exp2(-1e30) = 0
    float sub[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      sub[h] = m_new == kNegInf ? 0.f : m_new;
      corr[h] = fast_exp2(m[h] - sub[h]);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = fast_exp2(s[n][i] - sub[i >> 1]);
        l[i >> 1] += s[n][i];
      }

    // O = O corr + P V, P straight from the accumulators; each n-tile's
    // sum over the tile's keys starts from 0 on the tensor cores and is
    // added to O in fp32
    FragA pa[NT];
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) acc_a(pa[kk], s[kk]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        FragB bv;
        load_b_n<LV>(bv, sv, kk * 8, n * 8, g, t);
        mma3(acc, pa[kk], bv);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[n][i] = fmaf(o[n][i], corr[i >> 1], acc[i]);
    }
    __syncthreads();                        // the stage is free again
  }

  // O = acc / l; a row that sees no key gives o = 0 and lse = 0
  float* op = head_ptr(static_cast<float*>(p.o), p.so, b, hd);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float den = l[h] > 0.f ? l[h] : 1.f;
    const int row = row0 + 8 * h;
    if (row >= p.Tq) continue;
    float* orow = op + (size_t)row * p.so.t + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[n][2 * h] / den, o[n][2 * h + 1] / den);
    if (t == 0 && c0 == 0)
      p.lse[(size_t)bh * p.Tq + row] =
          l[h] > 0.f ? m[h] * kLn2 + logf(l[h]) : 0.f;
  }
}

// shared memory of flash_bwd_q_tf32, in floats: Q and dO (64 x LQ), then
// two stages of K and V tiles (KT x LQ)
template <int D, int KT>
struct QF32Smem {
  static constexpr int LQ = D + 4;
  static constexpr int DO = 64 * LQ;
  static constexpr int KV = 2 * 64 * LQ;               // + s * STAGE
  static constexpr int STAGE = 2 * KT * LQ;
  static constexpr size_t BYTES = (size_t)(KV + 2 * STAGE) * sizeof(float);
};

// dQ of the 64 query rows q0 .. q0 + 63 in float32, columns c0 .. c0 +
// DOUT - 1.  Per K tile of KT keys: S = Q K^T and dP = dO V^T, P =
// exp2(S scale log2 e - lse2) (0 where masked), dS = P (dP - delta)
// scale, dQ += dS K.  The prologue computes delta = rowsum(dO * O) of the
// block's rows and (the first column slice) writes it with lse2 = lse *
// log2(e) into the padded arrays (0 past Tq) that flash_bwd_kv_tf32 reads.
// Accumulator element [j][i]: row row0 + 8 (i >> 1), key 8 j + 2 t + (i &
// 1).
template <int D, int KT, int DOUT, int MINB>
__global__ void __launch_bounds__(128, MINB)
flash_bwd_q_tf32(const BwdParams p, float* delta, float* lse2, int tq_pad,
                 float scale_log2) {
  using L = QF32Smem<D, KT>;
  constexpr int LQ = L::LQ, NT = KT / 8, NO = DOUT / 8;
  constexpr int KC = D <= 128 ? D / 64 : 1, KU = D <= 128 ? 8 : 4;
  extern __shared__ __align__(16) float smf[];
  __shared__ float s_delta[64];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x / (D / DOUT);
  const int c0 = (blockIdx.x % (D / DOUT)) * DOUT;
  const int bh = tile / p.n_qtiles;
  const int q0 = (tile % p.n_qtiles) * 64;
  const int b = bh / p.H, hd = bh % p.H;
  const float* q = head_ptr(static_cast<const float*>(p.q), p.sq, b, hd);
  const float* k = head_ptr(static_cast<const float*>(p.k), p.sk, b, hd);
  const float* v = head_ptr(static_cast<const float*>(p.v), p.sv, b, hd);
  const float* dout =
      head_ptr(static_cast<const float*>(p.dout), p.sdo, b, hd);
  const int kvlen = valid_keys(p, b);
  const int n_tiles = key_tiles<64, KT>(p, kvlen, q0);
  const float* sq = smf;
  const float* sdo = smf + L::DO;

  auto stage_kv = [&](int j) {
    float* sk = smf + L::KV + (j & 1) * L::STAGE;
    stage_tile<KT, D, LQ>(sk, k, p.sk.t, j * KT, p.Tk, 0, tid);
    stage_tile<KT, D, LQ>(sk + KT * LQ, v, p.sv.t, j * KT, p.Tk, 0, tid);
  };
  if (n_tiles > 0) {
    stage_tile<64, D, LQ>(smf, q, p.sq.t, q0, p.Tq, 0, tid);
    stage_tile<64, D, LQ>(smf + L::DO, dout, p.sdo.t, q0, p.Tq, 0, tid);
    stage_kv(0);
  }
  cp_async_commit();

  // delta of the block's 64 rows, two threads a row, while the first tiles
  // load
  {
    const int r = tid >> 1, row = q0 + r;
    float sum = 0.f;
    if (row < p.Tq) {
      const int h0 = (tid & 1) * (D / 2);
      const float4* o4 = reinterpret_cast<const float4*>(
          head_ptr(static_cast<const float*>(p.o), p.so, b, hd) +
          (size_t)row * p.so.t + h0);
      const float4* d4 = reinterpret_cast<const float4*>(
          dout + (size_t)row * p.sdo.t + h0);
#pragma unroll 4
      for (int i = 0; i < D / 8; ++i) {
        const float4 a = o4[i], e = d4[i];
        sum += a.x * e.x + a.y * e.y + a.z * e.z + a.w * e.w;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((tid & 1) == 0) s_delta[r] = sum;
    if ((tid & 1) == 0 && c0 == 0) {
      const size_t at = (size_t)bh * tq_pad + row;
      delta[at] = sum;
      lse2[at] = row < p.Tq ? p.lse[(size_t)bh * p.Tq + row] * kLog2e : 0.f;
    }
  }
  __syncthreads();
  const int row0 = q0 + warp * 16 + g;      // this thread's rows: row0, +8
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    lse_r[h] = row < p.Tq ? p.lse[(size_t)bh * p.Tq + row] * kLog2e : 0.f;
    dl_r[h] = s_delta[row - q0];
  }
  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      stage_kv(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sk = smf + L::KV + (j & 1) * L::STAGE;
    const float* sv = sk + KT * LQ;
    const int k0 = j * KT;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
    // S and dP in chunks of 64 dims, as in flash_fwd_tf32
#pragma unroll KC
    for (int ch = 0; ch < D / 64; ++ch) {
      float sc[NT][4] = {}, dc[NT][4] = {};
#pragma unroll KU
      for (int kk = 8 * ch; kk < 8 * ch + 8; ++kk) {
        FragA aq, ad;
        load_a<LQ>(aq, sq, warp * 16, kk * 8, g, t);
        load_a<LQ>(ad, sdo, warp * 16, kk * 8, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          FragB bk, bv;
          load_b_k<LQ>(bk, sk, n * 8, kk * 8, g, t);
          mma3(sc[n], aq, bk);
          load_b_k<LQ>(bv, sv, n * 8, kk * 8, g, t);
          mma3(dc[n], ad, bv);
        }
      }
      add_acc(s, sc);
      add_acc(dp, dc);
    }

    // P; a tile with no masked pair takes the loop without mask tests, one
    // masked only by the valid length and Tq a loop with a test a key and
    // a query
    if (tile_unmasked<64, KT>(p, kvlen, q0, k0)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[n][i] = fast_exp2(s[n][i] * scale_log2 - lse_r[i >> 1]);
    } else if (!p.causal && p.qseg == nullptr) {
      const bool row_in[2] = {row0 < p.Tq, row0 + 8 < p.Tq};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[n][i] = row_in[i >> 1] && k0 + 8 * n + 2 * t + (i & 1) < kvlen
                        ? fast_exp2(s[n][i] * scale_log2 - lse_r[i >> 1])
                        : 0.f;
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[n][i] = visible(p, b, kvlen, row0 + 8 * (i >> 1),
                            k0 + 8 * n + 2 * t + (i & 1))
                        ? fast_exp2(s[n][i] * scale_log2 - lse_r[i >> 1])
                        : 0.f;
    }
    // dS, then dQ += dS K with dS straight from the accumulators
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp[n][i] = s[n][i] * (dp[n][i] - dl_r[i >> 1]) * p.scale;
    FragA da[NT];
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) acc_a(da[kk], dp[kk]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        FragB bk;
        load_b_n<LQ>(bk, sk, kk * 8, c0 + n * 8, g, t);
        mma3(acc, da[kk], bk);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) dq[n][i] += acc[i];
    }
    __syncthreads();                        // the stage is free again
  }

  float* dqp = head_ptr(static_cast<float*>(p.dq), p.sdq, b, hd);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= p.Tq) continue;
    float* r = dqp + (size_t)row * p.sdq.t + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(r + 8 * n) =
          make_float2(dq[n][2 * h], dq[n][2 * h + 1]);
  }
}

// shared memory of flash_bwd_kv_tf32, in floats: K and V (64 x LQ), then
// two stages of Q and dO tiles (RT x LQ) with their lse2 and delta (RT
// each)
template <int D, int RT>
struct KvF32Smem {
  static constexpr int LQ = D + 4;
  static constexpr int V = 64 * LQ;
  static constexpr int QS = 2 * 64 * LQ;               // + s * STAGE
  static constexpr int DO = RT * LQ;                   // within a stage
  static constexpr int LSE = 2 * RT * LQ;              // within a stage
  static constexpr int STAGE = 2 * RT * LQ + 2 * RT;
  static constexpr size_t BYTES = (size_t)(QS + 2 * STAGE) * sizeof(float);
};

// dK and dV of the 64 keys k0 .. k0 + 63 in float32, columns c0 .. c0 +
// DOUT - 1.  Per Q tile of RT queries: S^T = K Q^T and dP^T = V dO^T, P^T
// = exp2(S^T scale log2 e - lse2) (0 where masked), dS^T = P^T (dP^T -
// delta) scale, dV += P^T dO and dK += dS^T Q.  Accumulator element [j][i]:
// key key0 + 8 (i >> 1), query q0 + 8 j + 2 t + (i & 1).
template <int D, int RT, int DOUT, int MINB>
__global__ void __launch_bounds__(128, MINB)
flash_bwd_kv_tf32(const BwdParams p, const float* delta, const float* lse2,
                  int tq_pad, float scale_log2) {
  using L = KvF32Smem<D, RT>;
  constexpr int LQ = L::LQ, NR = RT / 8, NO = DOUT / 8;
  constexpr int KC = D <= 128 ? D / 64 : 1, KU = D <= 128 ? 8 : 4;
  extern __shared__ __align__(16) float smf[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x / (D / DOUT);
  const int c0 = (blockIdx.x % (D / DOUT)) * DOUT;
  const int bh = tile / p.n_ktiles;
  const int k0 = (tile % p.n_ktiles) * 64;
  const int b = bh / p.H, hd = bh % p.H;
  const float* q = head_ptr(static_cast<const float*>(p.q), p.sq, b, hd);
  const float* k = head_ptr(static_cast<const float*>(p.k), p.sk, b, hd);
  const float* v = head_ptr(static_cast<const float*>(p.v), p.sv, b, hd);
  const float* dout =
      head_ptr(static_cast<const float*>(p.dout), p.sdo, b, hd);
  const int kvlen = valid_keys(p, b);
  const int it0 = first_query_tile(p, k0, RT);
  // keys at or past the valid length see nothing: dK = dV = 0
  const int n_tiles = (k0 < kvlen ? (p.Tq + RT - 1) / RT : 0) - it0;
  const float* sk = smf;
  const float* sv = smf + L::V;

  auto stage_q = [&](int n) {
    const int it = it0 + n;
    float* sq = smf + L::QS + (n & 1) * L::STAGE;
    stage_tile<RT, D, LQ>(sq, q, p.sq.t, it * RT, p.Tq, 0, tid);
    stage_tile<RT, D, LQ>(sq + L::DO, dout, p.sdo.t, it * RT, p.Tq, 0, tid);
    const size_t row = (size_t)bh * tq_pad + (size_t)it * RT;
    if (tid < RT / 4)
      cp_async16(sq + L::LSE + 4 * tid, lse2 + row + 4 * tid, 16);
    else if (tid < RT / 2)
      cp_async16(sq + L::LSE + 4 * tid, delta + row + 4 * tid - RT, 16);
  };
  if (n_tiles > 0) {
    stage_tile<64, D, LQ>(smf, k, p.sk.t, k0, p.Tk, 0, tid);
    stage_tile<64, D, LQ>(smf + L::V, v, p.sv.t, k0, p.Tk, 0, tid);
    stage_q(0);
  }
  cp_async_commit();

  const int key0 = k0 + warp * 16 + g;      // this thread's keys: key0, +8
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  for (int n_ = 0; n_ < n_tiles; ++n_) {
    if (n_ + 1 < n_tiles) {
      stage_q(n_ + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sq = smf + L::QS + (n_ & 1) * L::STAGE;
    const float* sdo = sq + L::DO;
    const float* slse = sq + L::LSE;
    const float* sdl = slse + RT;
    const int q0 = (it0 + n_) * RT;

    float st[NR][4], dpt[NR][4];
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
    // S^T and dP^T in chunks of 64 dims, as in flash_fwd_tf32
#pragma unroll KC
    for (int ch = 0; ch < D / 64; ++ch) {
      float sc[NR][4] = {}, dc[NR][4] = {};
#pragma unroll KU
      for (int kk = 8 * ch; kk < 8 * ch + 8; ++kk) {
        FragA ak, av;
        load_a<LQ>(ak, sk, warp * 16, kk * 8, g, t);
        load_a<LQ>(av, sv, warp * 16, kk * 8, g, t);
#pragma unroll
        for (int n = 0; n < NR; ++n) {
          FragB bq, bo;
          load_b_k<LQ>(bq, sq, n * 8, kk * 8, g, t);
          mma3(sc[n], ak, bq);
          load_b_k<LQ>(bo, sdo, n * 8, kk * 8, g, t);
          mma3(dc[n], av, bo);
        }
      }
      add_acc(st, sc);
      add_acc(dpt, dc);
    }

    // P^T; a tile with no masked pair takes the loop without mask tests,
    // one masked only by the valid length and Tq a loop with a test a key
    // and a query
    const bool key_in[2] = {key0 < kvlen, key0 + 8 < kvlen};
    if (tile_unmasked<RT>(p, kvlen, q0, k0)) {
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          st[n][i] = fast_exp2(st[n][i] * scale_log2 -
                               slse[8 * n + 2 * t + (i & 1)]);
    } else if (!p.causal && p.qseg == nullptr) {
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = 8 * n + 2 * t + (i & 1);
          st[n][i] = key_in[i >> 1] && q0 + qc < p.Tq
                         ? fast_exp2(st[n][i] * scale_log2 - slse[qc])
                         : 0.f;
        }
    } else {
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = 8 * n + 2 * t + (i & 1);
          st[n][i] = visible(p, b, kvlen, q0 + qc, key0 + 8 * (i >> 1))
                         ? fast_exp2(st[n][i] * scale_log2 - slse[qc])
                         : 0.f;
        }
    }
    // dS^T, then dV += P^T dO and dK += dS^T Q from the accumulators
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dpt[n][i] = st[n][i] *
                    (dpt[n][i] - sdl[8 * n + 2 * t + (i & 1)]) * p.scale;
    // P^T's fragments for dV, then dS^T's for dK: one set live at a time
    FragA pa[NR], da[NR];
#pragma unroll
    for (int kk = 0; kk < NR; ++kk) acc_a(pa[kk], st[kk]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NR; ++kk) {
        FragB bo;
        load_b_n<LQ>(bo, sdo, kk * 8, c0 + n * 8, g, t);
        mma3(acc, pa[kk], bo);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[n][i] += acc[i];
    }
#pragma unroll
    for (int kk = 0; kk < NR; ++kk) acc_a(da[kk], dpt[kk]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NR; ++kk) {
        FragB bq;
        load_b_n<LQ>(bq, sq, kk * 8, c0 + n * 8, g, t);
        mma3(acc, da[kk], bq);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) dk[n][i] += acc[i];
    }
    __syncthreads();                        // the stage is free again
  }

  float* dkp = head_ptr(static_cast<float*>(p.dk), p.sdk, b, hd);
  float* dvp = head_ptr(static_cast<float*>(p.dv), p.sdv, b, hd);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= p.Tk) continue;
    float* kr = dkp + (size_t)key * p.sdk.t + c0 + 2 * t;
    float* vr = dvp + (size_t)key * p.sdv.t + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<float2*>(kr + 8 * n) =
          make_float2(dk[n][2 * h], dk[n][2 * h + 1]);
      *reinterpret_cast<float2*>(vr + 8 * n) =
          make_float2(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

template <int D>
struct F32Kernels {
  using C = F32Tiles<D>;
  static constexpr auto fwd =
      flash_fwd_tf32<D, C::FWD_K, C::FWD_DOUT, C::FWD_MINB>;
  static constexpr auto q = flash_bwd_q_tf32<D, C::Q_K, C::Q_DOUT, C::Q_MINB>;
  static constexpr auto kv =
      flash_bwd_kv_tf32<D, C::KV_R, C::KV_DOUT, C::KV_MINB>;
  static constexpr size_t fwd_smem =
      FwdF32Smem<D, C::FWD_K, C::FWD_DOUT>::BYTES;
  static constexpr size_t q_smem = QF32Smem<D, C::Q_K>::BYTES;
  static constexpr size_t kv_smem = KvF32Smem<D, C::KV_R>::BYTES;
};

// the float32 forward of head dim D
template <int D>
int launch_fwd_tf32(StridedParams p, int BH, cudaStream_t s) {
  using K = F32Kernels<D>;
  p.n_qtiles = (p.Tq + 63) / 64;
  return launch(K::fwd, (long long)BH * p.n_qtiles * (D / K::C::FWD_DOUT),
                128, K::fwd_smem, s, p, p.scale * kLog2e);
}

// dQ (with delta and lse2 into the scratch), then dK and dV, in float32
template <int D>
int launch_bwd_tf32(BwdParams p, float* delta, float* lse2, int tq_pad,
                    int BH, cudaStream_t s) {
  using K = F32Kernels<D>;
  const float c = p.scale * kLog2e;
  int rc = launch(K::q, (long long)BH * p.n_qtiles * (D / K::C::Q_DOUT), 128,
                  K::q_smem, s, p, delta, lse2, tq_pad, c);
  if (rc != 0) return rc;
  return launch(K::kv, (long long)BH * p.n_ktiles * (D / K::C::KV_DOUT), 128,
                K::kv_smem, s, p, (const float*)delta, (const float*)lse2,
                tq_pad, c);
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so the
// library needs no link against libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// the 16-bit operand at `ptr` (type `dt`) with strides s as a 4-d tensor
// map (D, T, H, B) with boxes of 64 columns by `rows` rows of one head,
// 128-byte swizzled, zeros past T.  T is a dimension of its own, so the
// ragged last tile of a head reads zeros, never the next batch's first rows.
// TMA takes strides in any order, multiples of 16 bytes (the caller checks
// them).
int make_map(CUtensorMap* map, CUtensorMapDataType dt, const void* ptr,
             const Strides& s, int T, int H, int B, int D, int rows) {
  EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(T > 0 ? T : 1),
                              (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.t * 2, (cuuint64_t)s.h * 2,
                                 (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, dt, 4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The tiles, ring stages and register bounds of the 16-bit (bf16 and f16)
// backward at head dim D (the reasons are in the note above the kernels).
// BR: the Q/dO tile rows of the dK/dV kernel; MINB: the blocks an SM a
// kernel is compiled for, which bounds its registers to 65536 / (128 MINB);
// DOUT: the output columns of dQ (dK and dV) a block accumulates.  Up to D
// 128 a block holds all D; above, the accumulators (2 x 64 x D fp32 of dK
// and dV in one warpgroup) would not fit its registers, so each block takes
// a 64-column slice and the grid D / 64 blocks a tile, each recomputing S
// and dP over the whole D (2.5x the products at D 256); shared memory then
// holds one block an SM.
template <int D>
struct Bwd16;
template <>
struct Bwd16<64> {
  static constexpr int BR = 64, KV_STAGES = 3, Q_STAGES = 3;
  static constexpr int KV_MINB = 2, Q_MINB = 2, DOUT = 64;
};
template <>
struct Bwd16<128> {
  static constexpr int BR = 32, KV_STAGES = 3, Q_STAGES = 2;
  static constexpr int KV_MINB = 2, Q_MINB = 2, DOUT = 128;
};
template <>
struct Bwd16<192> {
  static constexpr int BR = 32, KV_STAGES = 3, Q_STAGES = 2;
  static constexpr int KV_MINB = 1, Q_MINB = 1, DOUT = 64;
};
template <>
struct Bwd16<256> {
  static constexpr int BR = 32, KV_STAGES = 3, Q_STAGES = 2;
  static constexpr int KV_MINB = 1, Q_MINB = 1, DOUT = 64;
};

template <int DT, int D>
struct Bwd16Kernels {
  using C = Bwd16<D>;
  static constexpr auto q =
      flash_bwd_q_hopper<DT, D, C::Q_STAGES, C::Q_MINB, C::DOUT>;
  static constexpr auto kv =
      flash_bwd_kv_hopper<DT, D, C::BR, C::KV_STAGES, C::KV_MINB, C::DOUT>;
  static constexpr size_t q_smem = QSmem<D, C::Q_STAGES>::BYTES + 1024;
  static constexpr size_t kv_smem =
      KvSmem<D, C::BR, C::KV_STAGES>::BYTES + 1024;
};

// dQ, then dK and dV, on the Hopper kernels (DT 1 or 2)
template <int DT, int D>
int launch_bwd_hopper(const BwdParams& p, float* delta, float* lse2,
                      int tq_pad, int BH, cudaStream_t s) {
  using K = Bwd16Kernels<DT, D>;
  constexpr int BR = Bwd16<D>::BR;
  constexpr int SLICES = D / Bwd16<D>::DOUT;
  constexpr CUtensorMapDataType dt = Elem<DT>::tma;
  HopperBwd hp;
  hp.p = p;
  hp.delta = delta;
  hp.lse2 = lse2;
  hp.tq_pad = tq_pad;
  hp.scale_log2 = p.scale * kLog2e;
  const int B = BH / p.H;
  // The tensor maps are encoded through the driver, which needs the
  // device's context current on this thread.  Autograd runs a backward on
  // a thread of its own, where nothing may have bound the context yet
  // (PyTorch avoids binding it on its own), so bind it here.
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0) rc = (int)cudaSetDevice(dev);
  if (rc == 0) rc = make_map(&hp.tq, dt, p.q, p.sq, p.Tq, p.H, B, D, 64);
  if (rc == 0) rc = make_map(&hp.tdo, dt, p.dout, p.sdo, p.Tq, p.H, B, D, 64);
  if (rc == 0) rc = make_map(&hp.tk, dt, p.k, p.sk, p.Tk, p.H, B, D, 64);
  if (rc == 0) rc = make_map(&hp.tv, dt, p.v, p.sv, p.Tk, p.H, B, D, 64);
  if (rc == 0)
    rc = launch(K::q, (long long)BH * p.n_qtiles * SLICES, 128, K::q_smem, s,
                hp);
  if (rc == 0 && BR != 64) {
    rc = make_map(&hp.tq, dt, p.q, p.sq, p.Tq, p.H, B, D, BR);
    if (rc == 0)
      rc = make_map(&hp.tdo, dt, p.dout, p.sdo, p.Tq, p.H, B, D, BR);
  }
  if (rc == 0)
    rc = launch(K::kv, (long long)BH * p.n_ktiles * SLICES, 128, K::kv_smem,
                s, hp);
  return rc;
}

// The ring stages and register bounds of the 16-bit forward at head dim D:
// one warpgroup of 64 query rows a block with STAGES K/V buffers, compiled
// for MINB blocks an SM, which bounds the registers to 65536 / (128 MINB).
// In iteration j the ring holds tile j - 1 (in P V), tile j (in S = Q K^T)
// and the released tile j - 2 until its refill, so STAGES - 3 tiles are
// loaded ahead of use and the refilled one is in flight.  Two warpgroups a
// block (128 query rows sharing each K/V tile) measured 4% faster at
// BERT-base's shape and 20% slower at (1, 12, 2048, 2048, 64), where the
// grid of 128-row tiles leaves SMs empty (PERF.md), so one it is.
template <int D>
struct Fwd16;
template <>
struct Fwd16<64> {
  static constexpr int STAGES = 4, MINB = 3;
};
template <>
struct Fwd16<128> {
  static constexpr int STAGES = 3, MINB = 2;
};
// D 192 and 256: O is 64 x D fp32 in the warpgroup's registers (96 and 128
// a thread), so one block an SM (MINB 1, up to 255 registers); the Q tile
// and three K/V stages take 168 KB and 224 KB of shared memory
template <>
struct Fwd16<192> {
  static constexpr int STAGES = 3, MINB = 1;
};
template <>
struct Fwd16<256> {
  static constexpr int STAGES = 3, MINB = 1;
};

template <int DT, int D>
struct Fwd16Kernel {
  using C = Fwd16<D>;
  static constexpr auto kernel = flash_fwd_hopper<DT, D, C::STAGES, C::MINB>;
  static constexpr size_t smem = FwdSmem<D, C::STAGES>::BYTES + 1024;
};

// the forward on the Hopper kernel (DT 1 or 2, D 64 or 128)
template <int DT, int D>
int launch_fwd_hopper(const StridedParams& p, int BH, cudaStream_t s) {
  using K = Fwd16Kernel<DT, D>;
  constexpr CUtensorMapDataType dt = Elem<DT>::tma;
  HopperFwd hf;
  hf.p = p;
  hf.p.n_qtiles = (p.Tq + 63) / 64;
  hf.scale_log2 = p.scale * kLog2e;
  const int B = BH / p.H;
  // the tensor maps need the device's context on this thread (as in
  // launch_bwd_hopper)
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0) rc = (int)cudaSetDevice(dev);
  if (rc == 0) rc = make_map(&hf.tq, dt, p.q, p.sq, p.Tq, p.H, B, D, 64);
  if (rc == 0) rc = make_map(&hf.tk, dt, p.k, p.sk, p.Tk, p.H, B, D, 64);
  if (rc == 0) rc = make_map(&hf.tv, dt, p.v, p.sv, p.Tk, p.H, B, D, 64);
  if (rc == 0) rc = make_map(&hf.to, dt, p.o, p.so, p.Tq, p.H, B, D, 64);
  if (rc == 0)
    rc = launch(K::kernel, (long long)BH * hf.p.n_qtiles, 128, K::smem, s,
                hf);
  return rc;
}

template <typename Kernel>
int occupancy(Kernel kernel, int threads, size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                        threads, smem);
  return (int)err;
}

// the 16-bit forward (DT 1 or 2) on the Hopper kernel of head dim D
template <int DT>
int fwd_16(StridedParams& p, int BH, int D, cudaStream_t s) {
  if (D == 64) return launch_fwd_hopper<DT, 64>(p, BH, s);
  if (D == 128) return launch_fwd_hopper<DT, 128>(p, BH, s);
  if (D == 192) return launch_fwd_hopper<DT, 192>(p, BH, s);
  return launch_fwd_hopper<DT, 256>(p, BH, s);
}

// The forward over operands with strides (B H of them, B = BH / H), D = 64,
// 128, 192 or 256, of `dtype` (0 = float32, 1 = bfloat16, 2 = float16): the
// wgmma kernel for the 16-bit types, the three-TF32 mma.sync kernel for
// float32.  The caller
// checks that every stride is a multiple of 16 bytes and every pointer
// 16-byte aligned.
int run_fwd(StridedParams& p, int BH, int D, int dtype, cudaStream_t s) {
  if (dtype == 1) return fwd_16<1>(p, BH, D, s);
  if (dtype == 2) return fwd_16<2>(p, BH, D, s);
  if (D == 64) return launch_fwd_tf32<64>(p, BH, s);
  if (D == 128) return launch_fwd_tf32<128>(p, BH, s);
  if (D == 192) return launch_fwd_tf32<192>(p, BH, s);
  return launch_fwd_tf32<256>(p, BH, s);
}

// the 16-bit backward (DT 1 or 2) on the Hopper kernels of head dim D;
// delta and lse * log2(e), padded to whole 64-row tiles for the dK/dV
// kernel's bulk copies, are written by the dQ kernel into the scratch
template <int DT>
int bwd_16(BwdParams& p, int BH, int D, void* delta, cudaStream_t s) {
  const int pad = (p.Tq + 63) / 64 * 64;
  float* dl = static_cast<float*>(delta);
  float* lse2 = dl + (size_t)BH * pad;
  if (D == 64) return launch_bwd_hopper<DT, 64>(p, dl, lse2, pad, BH, s);
  if (D == 128) return launch_bwd_hopper<DT, 128>(p, dl, lse2, pad, BH, s);
  if (D == 192) return launch_bwd_hopper<DT, 192>(p, dl, lse2, pad, BH, s);
  return launch_bwd_hopper<DT, 256>(p, dl, lse2, pad, BH, s);
}

// The backward, as run_fwd; delta: scratch of 2 x BH x Tq_pad floats.
int run_bwd(BwdParams& p, int BH, int D, int dtype, void* delta,
            cudaStream_t s) {
  p.n_qtiles = (p.Tq + BQ - 1) / BQ;
  p.n_ktiles = (p.Tk + BK - 1) / BK;
  if (dtype == 1) return bwd_16<1>(p, BH, D, delta, s);
  if (dtype == 2) return bwd_16<2>(p, BH, D, delta, s);
  const int pad = (p.Tq + 63) / 64 * 64;
  float* dl = static_cast<float*>(delta);
  float* lse2 = dl + (size_t)BH * pad;
  if (D == 64) return launch_bwd_tf32<64>(p, dl, lse2, pad, BH, s);
  if (D == 128) return launch_bwd_tf32<128>(p, dl, lse2, pad, BH, s);
  if (D == 192) return launch_bwd_tf32<192>(p, dl, lse2, pad, BH, s);
  return launch_bwd_tf32<256>(p, dl, lse2, pad, BH, s);
}

bool bad_args(int BH, int H, int Tq, int Tk, int D, int dtype) {
  return BH < 0 || H <= 0 || BH % H != 0 || Tq < 0 || Tk < 0 ||
         (D != 64 && D != 128 && D != 192 && D != 256) || dtype < 0 ||
         dtype > 2;
}

// the strides of a contiguous (B, H, T, D) operand
Strides bhtd(int H, int T, int D) {
  return Strides{(long long)H * T * D, D, (long long)T * D};
}

// the strides of operand i of a (b, t, h) stride triple array
Strides strides_of(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

void fill(Params& p, const void* q, const void* k, const void* v,
          const void* o, const void* lse, const void* lens, int H, int Tq,
          int Tk, float scale, int causal) {
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = const_cast<void*>(o);
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.lens = static_cast<const int*>(lens);
  p.qseg = nullptr;
  p.kseg = nullptr;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.scale = scale;
  p.causal = causal;
}

}  // namespace

// q: BH x Tq x D, k and v: BH x Tk x D, o: BH x Tq x D, all contiguous, of
// `dtype` (0 = float32, 1 = bfloat16, 2 = float16), D = 64, 128, 192 or
// 256, the pointers 16-byte aligned; lse: BH x Tq floats.  lens: B ints or null; qseg: B x Tq ints and
// kseg: B x Tk ints, or both null; B = BH / H.  Returns a cudaError_t as int
// (0 = ok).
extern "C" int mx_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      const void* lens, const void* qseg,
                                      const void* kseg, int BH, int H, int Tq,
                                      int Tk, int D, float scale, int causal,
                                      int dtype, void* stream) {
  if (bad_args(BH, H, Tq, Tk, D, dtype) || (qseg == nullptr) != (kseg == nullptr))
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Tq == 0) return 0;
  StridedParams p;
  fill(p, q, k, v, o, lse, lens, H, Tq, Tk, scale, causal);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.sq = p.so = bhtd(H, Tq, D);
  p.sk = p.sv = bhtd(H, Tk, D);
  return run_fwd(p, BH, D, dtype, static_cast<cudaStream_t>(stream));
}

// The backward of mx_flash_attention_fwd.  q, o and dout: BH x Tq x D; k and
// v: BH x Tk x D; all contiguous, of `dtype`, D as for the forward, the
// pointers 16-byte aligned; lse: the forward's BH x Tq floats; delta: scratch of
// 2 x BH x Tq_pad floats, Tq_pad = Tq rounded up to 64, 16-byte aligned.
// dq (BH x Tq x D), dk and dv (BH x Tk x D), of `dtype`, are written whole:
// rows of dk and dv past a row's valid length are zeros.  lens, qseg, kseg,
// H, scale and causal as for the forward.  The kernels run in turn on
// `stream`: dq (with delta = rowsum(dout * o) and lse * log2(e) into the
// scratch), then dk and dv.  Returns a
// cudaError_t as int (0 = ok).
extern "C" int mx_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* dout,
                                      void* delta, void* dq, void* dk,
                                      void* dv, const void* lens,
                                      const void* qseg, const void* kseg,
                                      int BH, int H, int Tq, int Tk, int D,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (bad_args(BH, H, Tq, Tk, D, dtype) || (qseg == nullptr) != (kseg == nullptr))
    return (int)cudaErrorInvalidValue;
  if (BH == 0) return 0;
  BwdParams p;
  fill(p, q, k, v, o, lse, lens, H, Tq, Tk, scale, causal);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.sq = p.so = p.sdo = p.sdq = bhtd(H, Tq, D);
  p.sk = p.sv = p.sdk = p.sdv = bhtd(H, Tk, D);
  return run_bwd(p, BH, D, dtype, delta, static_cast<cudaStream_t>(stream));
}

// Replaces pallas_flash_attention_bshd (mxnet_tpu/ops/pallas_attention.py):
// the forward of mx_flash_attention_fwd over (B, T, H, D) operands addressed
// in place through their strides, without segment ids.  strides: 12
// elements, (batch, row, head) for q, k, v and o in turn, each a multiple
// of 16 bytes; D contiguous; the pointers 16-byte aligned.  lse: B x H x Tq
// floats, contiguous.  Returns a cudaError_t as int (0 = ok).
extern "C" int mx_flash_attention_bshd_fwd(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           const void* lens, int B, int H,
                                           int Tq, int Tk, int D,
                                           const long long* strides,
                                           float scale, int causal,
                                           int dtype, void* stream) {
  if (B < 0 || bad_args(B * H, H, Tq, Tk, D, dtype))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return 0;
  StridedParams p;
  fill(p, q, k, v, o, lse, lens, H, Tq, Tk, scale, causal);
  p.sq = strides_of(strides, 0);
  p.sk = strides_of(strides, 1);
  p.sv = strides_of(strides, 2);
  p.so = strides_of(strides, 3);
  return run_fwd(p, B * H, D, dtype, static_cast<cudaStream_t>(stream));
}

// Replaces pallas_flash_attention_bwd_bshd: the backward of
// mx_flash_attention_bshd_fwd, as mx_flash_attention_bwd over strided
// operands.  strides: 24 elements, (batch, row, head) for q, k, v, o, dout,
// dq, dk and dv in turn.  dq, dk and dv are written through their strides
// (the columns of one (B, T, 3 H D) gradient, say); the scratch delta is
// 2 x B x H x Tq_pad floats.  Returns a cudaError_t as int (0 = ok).
extern "C" int mx_flash_attention_bshd_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, const void* lens, int B, int H, int Tq, int Tk, int D,
    const long long* strides, float scale, int causal, int dtype,
    void* stream) {
  if (B < 0 || bad_args(B * H, H, Tq, Tk, D, dtype))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  BwdParams p;
  fill(p, q, k, v, o, lse, lens, H, Tq, Tk, scale, causal);
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.sq = strides_of(strides, 0);
  p.sk = strides_of(strides, 1);
  p.sv = strides_of(strides, 2);
  p.so = strides_of(strides, 3);
  p.sdo = strides_of(strides, 4);
  p.sdq = strides_of(strides, 5);
  p.sdk = strides_of(strides, 6);
  p.sdv = strides_of(strides, 7);
  return run_bwd(p, B * H, D, dtype, delta, static_cast<cudaStream_t>(stream));
}

// The resources of the Hopper backward kernels (16-bit, of `dtype` 1 or 2)
// at head dim D (64, 128, 192 or 256), for the build report: out[0..3] = blocks an SM
// and dynamic shared memory bytes a block of the dQ kernel, then of the
// dK/dV kernel.  Returns a cudaError_t as int (0 = ok).
template <int DT, int D>
int bwd_occupancy(int* out) {
  using K = Bwd16Kernels<DT, D>;
  out[1] = (int)K::q_smem;
  out[3] = (int)K::kv_smem;
  int rc = occupancy(K::q, 128, K::q_smem, &out[0]);
  if (rc == 0) rc = occupancy(K::kv, 128, K::kv_smem, &out[2]);
  return rc;
}

template <int DT>
int bwd_occupancy_of_type(int D, int* out) {
  if (D == 64) return bwd_occupancy<DT, 64>(out);
  if (D == 128) return bwd_occupancy<DT, 128>(out);
  if (D == 192) return bwd_occupancy<DT, 192>(out);
  return bwd_occupancy<DT, 256>(out);
}

// the float32 kernels' resources, as bwd_occupancy
template <int D>
int bwd_occupancy_f32(int* out) {
  using K = F32Kernels<D>;
  out[1] = (int)K::q_smem;
  out[3] = (int)K::kv_smem;
  int rc = occupancy(K::q, 128, K::q_smem, &out[0]);
  if (rc == 0) rc = occupancy(K::kv, 128, K::kv_smem, &out[2]);
  return rc;
}

int bwd_occupancy_f32_of(int D, int* out) {
  if (D == 64) return bwd_occupancy_f32<64>(out);
  if (D == 128) return bwd_occupancy_f32<128>(out);
  if (D == 192) return bwd_occupancy_f32<192>(out);
  return bwd_occupancy_f32<256>(out);
}

extern "C" int mx_flash_attention_bwd_occupancy(int D, int dtype, int* out) {
  if ((D != 64 && D != 128 && D != 192 && D != 256) || dtype < 0 ||
      dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return bwd_occupancy_f32_of(D, out);
  return dtype == 1 ? bwd_occupancy_of_type<1>(D, out)
                    : bwd_occupancy_of_type<2>(D, out);
}

// The resources of the Hopper forward kernel (16-bit, of `dtype` 1 or 2) at
// head dim D (64, 128, 192 or 256), for the build report: out[0..1] = blocks
// an SM of 128 threads and dynamic shared memory bytes a block.  Returns a
// cudaError_t as int (0 = ok).
template <int DT, int D>
int fwd_occupancy(int* out) {
  using K = Fwd16Kernel<DT, D>;
  out[1] = (int)K::smem;
  return occupancy(K::kernel, 128, K::smem, &out[0]);
}

template <int DT>
int fwd_occupancy_of_type(int D, int* out) {
  if (D == 64) return fwd_occupancy<DT, 64>(out);
  if (D == 128) return fwd_occupancy<DT, 128>(out);
  if (D == 192) return fwd_occupancy<DT, 192>(out);
  return fwd_occupancy<DT, 256>(out);
}

template <int D>
int fwd_occupancy_f32(int* out) {
  using K = F32Kernels<D>;
  out[1] = (int)K::fwd_smem;
  return occupancy(K::fwd, 128, K::fwd_smem, &out[0]);
}

int fwd_occupancy_f32_of(int D, int* out) {
  if (D == 64) return fwd_occupancy_f32<64>(out);
  if (D == 128) return fwd_occupancy_f32<128>(out);
  if (D == 192) return fwd_occupancy_f32<192>(out);
  return fwd_occupancy_f32<256>(out);
}

extern "C" int mx_flash_attention_fwd_occupancy(int D, int dtype, int* out) {
  if ((D != 64 && D != 128 && D != 192 && D != 256) || dtype < 0 ||
      dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return fwd_occupancy_f32_of(D, out);
  return dtype == 1 ? fwd_occupancy_of_type<1>(D, out)
                    : fwd_occupancy_of_type<2>(D, out);
}
