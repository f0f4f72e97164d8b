"""Flash attention: the forward and backward kernels' wrappers, their
plain PyTorch versions, the autograd Function that pairs them, the
per-shape dispatcher and the public op.

Counterpart of ``mxnet_tpu/ops/pallas_attention.py``.  Over (B, H, T, D)
operands:

    softmax(q·kᵀ·scale [+ masks])·v

with the JAX package's masks: ``causal`` (query row r sees keys c <= r),
``kv_lens`` (B,) per-row valid key length (clamped to Tk) and
``q_segments``/``kv_segments`` (B, T) packed-sequence ids.  A row that sees
no key gives 0.  :func:`flash_attention_fwd` launches the hand-written
kernel of ``csrc/flash_attention.cu`` for CUDA tensors (float32, bfloat16
or float16, D <= 256) or raises, and runs :func:`_flash_attention_plain`
for CPU tensors; it returns ``o`` and the fp32 ``lse``.  One CUDA kernel
covers both TPU forward kernels (the single-pass one and the streaming
one): it streams K tiles whatever Tk is.  bfloat16 and float16 run on
Hopper's TMA and ``wgmma`` at every D.  float32 runs on the tensor cores
too, through ``mma.sync``: fp32 FMAs peak at 67 TFLOP/s on the H100 and
one TF32 product keeps too few bits for float32, so each operand is split
into two TF32 parts (big and small) and each float32 product is formed
from three TF32 products (small·big + big·small + big·big, summed in fp32),
about 5e-7 relative a product, at up to 495/3 = 165 TFLOP/s of float32
work; each tile's sums start from 0 on the tensor cores and are added in
fp32, since the tensor cores' own accumulation truncates.  D is
zero-padded to the next of 64, 128, 192 and 256, as the Pallas kernels
pad it to a multiple of 64.

:func:`flash_attention_bwd` is the backward from the forward's ``o`` and
``lse`` and the cotangent ``do``, in the arithmetic of the TPU backward
kernels: ``p = exp(s - lse)``, ``dp = do·vᵀ``, ``ds = p∘(dp - δ)·scale``
with ``δ = rowsum(do∘o)`` in fp32, ``dv = pᵀ·do`` with p rounded to do's
dtype and ``dq = ds·k``, ``dk = dsᵀ·q`` with ds rounded to q's dtype.  It
launches the CUDA backward (one design for the three TPU backward kernels:
a dQ kernel that streams K tiles and a dK/dV kernel that streams Q tiles)
for CUDA tensors and runs :func:`_flash_attention_bwd_plain` for CPU
tensors.  :func:`flash_attention` runs the pair as one
``torch.autograd.Function`` where a gradient is recorded.

:func:`attention_dispatch` keeps the JAX package's per-shape choice and
its ``attention.kernel.*`` counters: min(Tq, Tk) < 128 goes to the
composed attention (differentiated by autograd, as the JAX package falls
back to the reference VJP there), Tk <= 1024 is ``short_seq`` (the
single-pass TPU kernel's domain) and longer K axes ``streaming``.  The
autotuner table is not ported, so ``tuner_source`` is always
``"heuristic"``.  The backward does not consult the dispatcher again.

The (B, T, H, D) entries (``pallas_flash_attention_bshd`` and its
backward in the JAX package): :func:`flash_attention_bshd_fwd` and
:func:`flash_attention_bshd_bwd` launch the same CUDA kernels on (B, T,
H, D) operands addressed in place through their strides: views with D
contiguous and 16-byte aligned strides and base, such as q, k and v as
column blocks of one fused projection output.  They make no transposed or
contiguous copy (only D is zero-padded, by a copy, where it is not one of
64, 128, 192 and 256); :func:`flash_attention_bshd` is their public op, and
:func:`self_attention_bshd` runs them over a fused (B, L, 3E) projection
output and writes the three gradients into one (B, L, 3E) tensor, the
path of ``MultiHeadAttention``.  They take no segment ids, as in the JAX
package, and count their launches in ``BSHD_LAUNCHES`` and
``BSHD_BWD_LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from .. import telemetry
from ..base import MXNetError
from .registry import register

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bshd", "flash_attention_bshd_fwd",
           "flash_attention_bshd_bwd", "self_attention_bshd",
           "attention_dispatch", "tune_attention_blocks", "LAUNCHES",
           "BWD_LAUNCHES", "BSHD_LAUNCHES", "BSHD_BWD_LAUNCHES"]

_NEG_INF = -1e30
# Kernel-selection constants of the JAX package (see attention_dispatch):
# the largest K axis the TPU's single-pass kernel takes whole, and the
# shortest sequence that goes to a kernel at all
_SHORT_SEQ_MAX_TK = 1024
_DENSE_MIN_SEQ = 128
# the CUDA forward kernels' tiles (csrc/flash_attention.cu): 64 query rows
# a block, 64 keys a K tile; the float32 kernel takes 32 keys a K tile
# above D 64 (its shared memory and registers)
BLOCK_Q = 64
BLOCK_K = 64
BLOCK_K_F32_WIDE = 32
_HEAD_DIMS = (64, 128, 192, 256)    # D is zero-padded up to one of these

# kernel launches in this process, forward and backward, through the
# (B, H, T, D) entries and through the (B, T, H, D) ones
LAUNCHES = 0
BWD_LAUNCHES = 0
BSHD_LAUNCHES = 0
BSHD_BWD_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FNS = {}
_CENSUSED = set()


def _kernel_fn(name="fwd"):
    if not _FNS:
        from .. import kernels
        lib = kernels.load("flash_attention")
        fn = lib.mx_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = lib.mx_flash_attention_bwd
        bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        occ = lib.mx_flash_attention_bwd_occupancy
        occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        occ.restype = ctypes.c_int
        focc = lib.mx_flash_attention_fwd_occupancy
        focc.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        focc.restype = ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        bfwd = lib.mx_flash_attention_bshd_fwd
        bfwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
            [strides, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
        bfwd.restype = ctypes.c_int
        bbwd = lib.mx_flash_attention_bshd_bwd
        bbwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + \
            [strides, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
        bbwd.restype = ctypes.c_int
        _FNS.update(fwd=fn, bwd=bwd, bwd_occupancy=occ,
                    fwd_occupancy=focc, bshd_fwd=bfwd, bshd_bwd=bbwd)
    return _FNS[name]


def tune_attention_blocks(seq_q, seq_k, head_dim, dtype="bfloat16"):
    """(block_q, block_k) of the CUDA forward kernel for a shape: 64 x 64
    on the wgmma kernel (bfloat16 and float16, every D) and on the float32
    kernel at D 64, 64 x 32 on the float32 kernel above D 64.  The TPU
    picked blocks up to the whole K axis under a VMEM budget; on the card a
    block's shared memory and a thread's registers set the tiles (the
    source's note).  The float32 kernels run three TF32 products on the
    tensor cores for each float32 product, so what bounds them is the
    tensor cores' rate and the fragment loads that feed them, not fp32
    FMAs; their K/V tiles stage by ``cp.async`` two deep with rows of D + 4
    floats, every fragment load free of bank conflicts.  (The backward's
    tiles are the source's ``F32Tiles``.)"""
    if str(dtype).replace("torch.", "") == "float32" \
            and head_dim > _HEAD_DIMS[0]:
        return BLOCK_Q, BLOCK_K_F32_WIDE
    return BLOCK_Q, BLOCK_K


def attention_dispatch(seq_q, seq_k, head_dim, dtype="bfloat16",
                       census=True):
    """Per-shape choice of the public op: ``{"kernel": "short_seq" |
    "streaming" | "dense_fallback", "block_q", "block_k",
    "tuner_source"}``.

    min(Tq, Tk) < 128 goes to the composed attention (``dense_fallback``),
    as in the JAX package; re-deriving that threshold for the card is
    measured work still to do.  Otherwise the kernel runs:
    ``short_seq`` where Tk <= 1024, where the JAX package runs its
    single-pass TPU kernel, and ``streaming`` above.  Both labels name
    the same CUDA kernel; they keep the census comparable.  (The JAX
    package's own label for 1024 < Tk <= 2048 depends on its VMEM budget;
    here it is always ``streaming``.)  ``census`` bumps
    ``attention.kernel.<label>`` once a call and journals a shape's first
    call."""
    if min(seq_q, seq_k) < _DENSE_MIN_SEQ:
        if census:
            telemetry.inc("attention.kernel.dense_fallback")
        return {"kernel": "dense_fallback", "block_q": None,
                "block_k": None, "tuner_source": None}
    block_q, block_k = tune_attention_blocks(seq_q, seq_k, head_dim, dtype)
    kernel = "short_seq" if seq_k <= _SHORT_SEQ_MAX_TK else "streaming"
    if census:
        telemetry.inc("attention.kernel.%s" % kernel)
        key = (int(seq_q), int(seq_k), int(head_dim), str(dtype))
        if key not in _CENSUSED:
            _CENSUSED.add(key)
            telemetry.event("attention_dispatch", kernel, seq_q=int(seq_q),
                            seq_k=int(seq_k), head_dim=int(head_dim),
                            dtype=str(dtype), block_q=block_q,
                            block_k=block_k, tuner_source="heuristic")
    return {"kernel": kernel, "block_q": block_q, "block_k": block_k,
            "tuner_source": "heuristic"}


def _visible(B, Tq, Tk, device, causal, kv_lens, q_segments, kv_segments):
    """(B, 1, Tq, Tk) bool: which key each query row sees, or None when
    every row sees every key."""
    mask = None
    if kv_lens is not None:
        lens = torch.clamp(kv_lens.to(device=device, dtype=torch.int64),
                           0, Tk)
        mask = torch.arange(Tk, device=device).view(1, 1, 1, Tk) \
            < lens.view(B, 1, 1, 1)
    if q_segments is not None:
        seg = q_segments.to(device).view(B, 1, Tq, 1) \
            == kv_segments.to(device).view(B, 1, 1, Tk)
        mask = seg if mask is None else mask & seg
    if causal:
        tri = torch.arange(Tq, device=device).view(Tq, 1) \
            >= torch.arange(Tk, device=device).view(1, Tk)
        mask = tri.view(1, 1, Tq, Tk) if mask is None else mask & tri
    return mask


def _check_segments(q, k, q_segments, kv_segments):
    if (q_segments is None) != (kv_segments is None):
        raise ValueError("q_segments and kv_segments go together")
    if q_segments is not None and (
            tuple(q_segments.shape) != (q.shape[0], q.shape[2])
            or tuple(kv_segments.shape) != (k.shape[0], k.shape[2])):
        raise ValueError("segment ids need shapes (B, Tq) and (B, Tk), got "
                         "%s and %s" % (tuple(q_segments.shape),
                                        tuple(kv_segments.shape)))


def _flash_attention_plain(q, k, v, causal=False, scale=None, kv_lens=None,
                           q_segments=None, kv_segments=None):
    """The plain PyTorch forward, in the arithmetic of the TPU's
    single-pass kernel: fp32 scores (float64 for float64 inputs), the
    row max, ``p = exp(s - m)`` zeroed where masked, ``p`` rounded to v's
    dtype before ``p·v`` with an fp32 sum, ``o = acc / l`` (l = 0 → o = 0)
    and ``lse = m + log l`` (0 where l = 0).  Returns ``(o, lse)``."""
    _check_segments(q, k, q_segments, kv_segments)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    cdt = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(cdt), k.to(cdt).transpose(-1, -2)) * scale
    mask = _visible(B, Tq, Tk, q.device, causal, kv_lens, q_segments,
                    kv_segments)
    if mask is not None:
        s = torch.where(mask, s, torch.full((), _NEG_INF, dtype=cdt,
                                            device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), dtype=cdt, device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).to(cdt), v.to(cdt))
    one = torch.ones((), dtype=cdt, device=q.device)
    o = (acc / torch.where(l > 0, l, one)).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l), torch.zeros_like(l))
    return o, lse.squeeze(-1).to(torch.float32)


def _flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False,
                               scale=None, kv_lens=None, q_segments=None,
                               kv_segments=None):
    """The plain PyTorch backward, in the arithmetic of the TPU backward
    kernels (``_bwd_core``, ``_scores_T``): fp32 scores (float64 for
    float64 inputs) masked to -1e30, ``p = exp(s - lse)``, ``dp = do·vᵀ``,
    ``δ = rowsum(do∘o)``, ``ds = p∘(dp - δ)·scale``; p rounded to do's
    dtype before ``dv = pᵀ·do`` and ds to q's dtype before ``dq = ds·k``
    and ``dk = dsᵀ·q``, every product summed in fp32.  Returns
    ``(dq, dk, dv)`` in the dtypes of q, k and v."""
    _check_segments(q, k, q_segments, kv_segments)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    cdt = torch.promote_types(q.dtype, torch.float32)
    qc, kc, vc, doc = (t.to(cdt) for t in (q, k, v, do))
    s = torch.matmul(qc, kc.transpose(-1, -2)) * scale
    mask = _visible(B, Tq, Tk, q.device, causal, kv_lens, q_segments,
                    kv_segments)
    if mask is not None:
        s = torch.where(mask, s, torch.full((), _NEG_INF, dtype=cdt,
                                            device=q.device))
    p = torch.exp(s - lse.to(cdt).unsqueeze(-1))
    dp = torch.matmul(doc, vc.transpose(-1, -2))
    delta = (doc * o.to(cdt)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dv = torch.matmul(p.to(do.dtype).to(cdt).transpose(-1, -2), doc)
    ds = ds.to(q.dtype).to(cdt)
    dq = torch.matmul(ds, kc)
    dk = torch.matmul(ds.transpose(-1, -2), qc)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _count(backward=False, bshd=False):
    global LAUNCHES, BWD_LAUNCHES, BSHD_LAUNCHES, BSHD_BWD_LAUNCHES
    with _COUNT_LOCK:
        if bshd and backward:
            BSHD_BWD_LAUNCHES += 1
        elif bshd:
            BSHD_LAUNCHES += 1
        elif backward:
            BWD_LAUNCHES += 1
        else:
            LAUNCHES += 1


def _mask_operands(B, device, kv_lens, q_segments, kv_segments):
    """The kernels' mask operands: kv_lens (B,) and the segment ids as
    contiguous int32 on ``device``, each None where absent."""
    lens = qs = ks = None
    if kv_lens is not None:
        lens = kv_lens.to(device=device, dtype=torch.int32).contiguous()
        if lens.shape != (B,):
            raise ValueError("kv_lens needs shape (%d,), got %s"
                             % (B, tuple(lens.shape)))
    if q_segments is not None:
        qs = q_segments.to(device=device, dtype=torch.int32).contiguous()
        ks = kv_segments.to(device=device, dtype=torch.int32).contiguous()
    return lens, qs, ks


def _ptrs(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def _kernel_operands(what, tensors, contiguous=True):
    """The device of ``tensors`` and the CUDA kernels' dtype code for them,
    after the checks every kernel makes: one device, float32, bfloat16 or
    float16 of one dtype, and contiguous where ``contiguous``.  ``None`` as
    the code: the tensors lie on the CPU."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise MXNetError("%s: operands on several devices %s"
                         % (what, sorted(map(str, devices))))
    device = devices.pop()
    if device.type == "cpu":
        return device, None
    if device.type != "cuda":
        raise MXNetError("%s: no kernel for device %s" % (what, device))
    code = _DTYPE_CODE.get(tensors[0].dtype)
    if code is None or any(t.dtype != tensors[0].dtype for t in tensors):
        raise MXNetError("%s: the CUDA kernel takes float32, bfloat16 or "
                         "float16 operands of one dtype, got %s"
                         % (what, ", ".join(str(t.dtype) for t in tensors)))
    if contiguous and not all(t.is_contiguous() for t in tensors):
        raise MXNetError("%s: the CUDA kernel takes contiguous operands"
                         % what)
    return device, code


def _on_meta(tensors):
    """Whether every operand lies on the ``meta`` device: a forward entry
    then returns outputs of the right shapes and dtypes without data (the
    shape rule ``Symbol.infer_shape`` runs the ops under); a CUDA or CPU
    tensor never takes that rule."""
    return all(t.device.type == "meta" for t in tensors)


def _padded_head_dim(what, D):
    Dp = next((d for d in _HEAD_DIMS if D <= d), None)
    if Dp is None:
        raise MXNetError("%s: the CUDA kernel takes head dims up to %d, got "
                         "%d; larger ones wait (ROADMAP.md, queue 2)"
                         % (what, _HEAD_DIMS[-1], D))
    return Dp


def flash_attention_fwd(q, k, v, causal=False, scale=None, kv_lens=None,
                        q_segments=None, kv_segments=None):
    """``(o, lse)`` of masked attention over contiguous (B, H, T, D)
    operands: o (B, H, Tq, D) in q's dtype, lse (B, H, Tq) fp32.
    Launches the CUDA kernel for CUDA tensors and runs the plain version
    for CPU tensors.  The kernel takes float32, bfloat16 or float16 q, k
    and v of one dtype, D <= 256 (zero-padded to 64, 128, 192 or 256 here)
    and contiguous operands, and raises on anything else."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError("flash_attention_fwd: q (B, H, Tq, D), k and v "
                         "(B, H, Tk, D), got %s, %s, %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    _check_segments(q, k, q_segments, kv_segments)
    if _on_meta((q, k, v)):
        return torch.empty_like(q), torch.empty(q.shape[:3],
                                                dtype=torch.float32,
                                                device=q.device)
    device, code = _kernel_operands("flash_attention_fwd", (q, k, v))
    if code is None:
        return _flash_attention_plain(q, k, v, causal, scale, kv_lens,
                                      q_segments, kv_segments)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    Dp = _padded_head_dim("flash_attention_fwd", D)
    scale = D ** -0.5 if scale is None else scale
    if Dp != D:
        pad = (0, Dp - D)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise MXNetError("flash_attention_fwd: the CUDA kernel takes "
                         "16-byte aligned q, k and v")
    o = torch.empty((B, H, Tq, Dp), dtype=q.dtype, device=device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=device)
    masks = _mask_operands(B, device, kv_lens, q_segments, kv_segments)
    fn = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), *_ptrs(masks), B * H, H, Tq, Tk, Dp,
                float(scale), int(bool(causal)), code, stream)
    if rc != 0:
        raise MXNetError("flash_attention_fwd: kernel launch failed with "
                         "CUDA error %d" % rc)
    _count()
    return (o if Dp == D else o[..., :D]), lse


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None,
                        kv_lens=None, q_segments=None, kv_segments=None):
    """``(dq, dk, dv)`` of :func:`flash_attention_fwd` from its ``o`` and
    ``lse`` and the cotangent ``do`` of o, in the dtypes of q, k and v.
    Launches the CUDA backward for CUDA tensors and runs the plain version
    for CPU tensors.  The kernels take q, k, v, o and do of one dtype,
    float32, bfloat16 or float16, D <= 256 (zero-padded to 64, 128, 192 or
    256 here; contiguous where D is one of those), and raise on anything
    else."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3] \
            or o.shape != q.shape or do.shape != q.shape \
            or lse.shape != q.shape[:3]:
        raise ValueError("flash_attention_bwd: q, o and do (B, H, Tq, D), k "
                         "and v (B, H, Tk, D), lse (B, H, Tq), got %s"
                         % ", ".join(str(tuple(t.shape))
                                     for t in (q, k, v, o, lse, do)))
    _check_segments(q, k, q_segments, kv_segments)
    # a head dim the kernels pad is copied into padded operands below, so
    # only an unpadded one must arrive contiguous (the forward's o at such
    # a D is a view of its padded output)
    device, code = _kernel_operands("flash_attention_bwd", (q, k, v, o, do),
                                    contiguous=q.shape[3] in _HEAD_DIMS)
    if code is None:
        return _flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale,
                                          kv_lens, q_segments, kv_segments)
    if lse.device != device or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise MXNetError("flash_attention_bwd: the CUDA kernel takes a "
                         "contiguous float32 lse on the operands' device")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    Dp = _padded_head_dim("flash_attention_bwd", D)
    scale = D ** -0.5 if scale is None else scale
    if Dp != D:
        pad = (0, Dp - D)
        q, k, v, o, do = (torch.nn.functional.pad(t, pad)
                          for t in (q, k, v, o, do))
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise MXNetError("flash_attention_bwd: the CUDA kernel takes "
                         "16-byte aligned operands")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    # the kernels' scratch: delta and lse * log2(e), each padded to whole
    # 64-row tiles
    delta = torch.empty(2 * B * H * (-(-Tq // 64) * 64), dtype=torch.float32,
                        device=device)
    masks = _mask_operands(B, device, kv_lens, q_segments, kv_segments)
    fn = _kernel_fn("bwd")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_ptrs(masks),
                B * H, H, Tq, Tk, Dp, float(scale), int(bool(causal)), code,
                stream)
    if rc != 0:
        raise MXNetError("flash_attention_bwd: kernel launch failed with "
                         "CUDA error %d" % rc)
    _count(backward=True)
    if Dp != D:
        dq, dk, dv = dq[..., :D], dk[..., :D], dv[..., :D]
    return dq, dk, dv


class _FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its backward kernel: forward
    :func:`flash_attention_fwd`, which saves q, k, v, o and lse; backward
    :func:`flash_attention_bwd`.  The mask operands get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_lens, q_segments,
                kv_segments):
        o, lse = flash_attention_fwd(q, k, v, causal, scale, kv_lens,
                                     q_segments, kv_segments)
        ctx.save_for_backward(q, k, v, o, lse, kv_lens, q_segments,
                              kv_segments)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_lens, q_segments, kv_segments = ctx.saved_tensors
        # do arrives strided from the head transpose that follows
        dq, dk, dv = flash_attention_bwd(
            q, k, v, _kernel_operand(o), lse, _kernel_operand(do),
            ctx.causal, ctx.scale, kv_lens, q_segments, kv_segments)
        return dq, dk, dv, None, None, None, None, None


def _composed_attention(q, k, v, causal=False, scale=None, kv_lens=None,
                        q_segments=None, kv_segments=None):
    """Composed attention, the JAX package's ``_reference_attention``:
    without ``kv_lens`` and segments its blockwise attention (see
    :func:`_blockwise_attention`), otherwise its masked dense form: scores
    in q's dtype then fp32, an fp32 softmax over the visible keys, rows
    that see nothing zeroed, the probabilities cast to q's dtype for
    ``p·v``."""
    _check_segments(q, k, q_segments, kv_segments)
    if kv_lens is None and q_segments is None:
        return _blockwise_attention(q, k, v, causal, scale)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    sc = D ** -0.5 if scale is None else scale
    s = torch.matmul(q, k.transpose(-1, -2)).float() * sc
    mask = _visible(B, Tq, Tk, q.device, causal, kv_lens, q_segments,
                    kv_segments)
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p,
                    torch.zeros((), device=q.device))
    return torch.matmul(p.to(q.dtype), v)


def _blockwise_attention(q, k, v, causal=False, scale=None, block=512):
    """The JAX package's ``blockwise_attention``
    (``parallel/ring_attention.py``): fp32 scores of the operands (never
    rounded to their dtype), 512-key blocks with a running max, the
    unnormalised ``exp(s - m)`` rounded to v's dtype for ``p·v`` with an
    fp32 sum, and one division by the fp32 normaliser at the end."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    sc = D ** -0.5 if scale is None else scale
    cdt = torch.promote_types(q.dtype, torch.float32)
    qc = q.to(cdt)
    m = torch.full((B, H, Tq), _NEG_INF, dtype=cdt, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=cdt, device=q.device)
    o = torch.zeros((B, H, Tq, D), dtype=cdt, device=q.device)
    rows = torch.arange(Tq, device=q.device).view(Tq, 1)
    for k0 in range(0, Tk, block):
        kb, vb = k[:, :, k0:k0 + block], v[:, :, k0:k0 + block]
        s = torch.matmul(qc, kb.to(cdt).transpose(-1, -2)) * sc
        if causal:
            cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            s = torch.where(rows >= cols.view(1, -1), s,
                            torch.full((), _NEG_INF, dtype=cdt,
                                       device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new.unsqueeze(-1))
        l = l * corr + p.sum(dim=-1)
        o = o * corr.unsqueeze(-1) + torch.matmul(p.to(v.dtype).to(cdt),
                                                  vb.to(cdt))
        m = m_new
    return (o / l.unsqueeze(-1)).to(q.dtype)


def _kernel_operand(t):
    """``t`` contiguous and 16-byte aligned (a copy where it is not)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def flash_attention(q, k, v, causal=False, scale=None, kv_lens=None,
                    q_segments=None, kv_segments=None):
    """Masked attention over (B, H, T, D) operands through the kernels
    (:func:`flash_attention_fwd`, and :func:`flash_attention_bwd` where a
    gradient is recorded) or, for short sequences, the composed attention,
    as :func:`attention_dispatch` decides.  Rows with no visible key
    return 0."""
    plan = attention_dispatch(q.shape[2], k.shape[2], q.shape[3], q.dtype)
    if plan["kernel"] == "dense_fallback":
        return _composed_attention(q, k, v, causal, scale, kv_lens,
                                   q_segments, kv_segments)
    return _FlashAttentionFunction.apply(
        _kernel_operand(q), _kernel_operand(k), _kernel_operand(v), causal,
        scale, kv_lens, q_segments, kv_segments)


# ---------------------------------------------------------------------------
# the (B, T, H, D) entries
# ---------------------------------------------------------------------------

def _bhtd(t):
    """(B, T, H, D) <-> (B, H, T, D), a view."""
    return t.transpose(1, 2)


def _flash_attention_bshd_plain(q, k, v, causal=False, scale=None,
                                kv_lens=None):
    """The plain forward over (B, T, H, D) operands: the (B, H, T, D) one
    on transposed views.  Returns ``(o, lse)``, o (B, Tq, H, D) and lse
    (B, H, Tq)."""
    o, lse = _flash_attention_plain(_bhtd(q), _bhtd(k), _bhtd(v), causal,
                                    scale, kv_lens)
    return _bhtd(o), lse


def _flash_attention_bshd_bwd_plain(q, k, v, o, lse, do, causal=False,
                                    scale=None, kv_lens=None):
    """The plain backward over (B, T, H, D) operands: the (B, H, T, D) one
    on transposed views.  Returns ``(dq, dk, dv)`` in (B, T, H, D)."""
    grads = _flash_attention_bwd_plain(_bhtd(q), _bhtd(k), _bhtd(v),
                                       _bhtd(o), lse, _bhtd(do), causal,
                                       scale, kv_lens)
    return tuple(_bhtd(g) for g in grads)


def _check_bshd(what, q, k, v, *more):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:] \
            or any(t.shape != q.shape for t in more):
        raise ValueError("%s: q%s (B, Tq, H, D), k and v (B, Tk, H, D), got "
                         "%s" % (what, " o and do" if more else "",
                                 ", ".join(str(tuple(t.shape))
                                           for t in (q, k, v) + more)))


def _bshd_strides(what, tensors):
    """The kernels' (batch, row, head) strides of each (B, T, H, D)
    operand, in elements, as a ctypes array; raises unless D is contiguous
    and the strides and the base are 16-byte aligned (what TMA and the
    16-byte loads need).  A size-1 axis, which is never stepped over, gets
    an aligned stride in place of its own."""
    vals = []
    for t in tensors:
        size = t.element_size()
        B, T, H, D = t.shape
        sb, st, sh, sd = t.stride()
        st = st if T > 1 else D * H
        sh = sh if H > 1 else D
        sb = sb if B > 1 else st * T
        if (sd != 1 and D > 1) or t.data_ptr() % 16 \
                or any(x * size % 16 for x in (sb, st, sh)):
            raise MXNetError(
                "%s: the CUDA kernel takes (B, T, H, D) operands with D "
                "contiguous and 16-byte aligned strides and base, got "
                "strides %s at offset %d" % (what, tuple(t.stride()),
                                             t.data_ptr() % 16))
        if (T + BLOCK_Q) * st >= 2 ** 31:
            raise MXNetError("%s: the CUDA kernel takes the rows of one "
                             "head within 2**31 elements, got %d rows %d "
                             "apart" % (what, T, st))
        vals += [sb, st, sh]
    return (ctypes.c_longlong * len(vals))(*vals)


def _bshd_operand(t):
    """``t`` as the kernels take it: as it is where its layout fits,
    otherwise a contiguous copy (16-byte aligned)."""
    size = t.element_size()
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 \
            and all(x * size % 16 == 0 for x in t.stride()[:3]):
        return t
    return _kernel_operand(t)


def flash_attention_bshd_fwd(q, k, v, causal=False, scale=None,
                             kv_lens=None):
    """``(o, lse)`` of masked attention over (B, T, H, D) operands: o
    (B, Tq, H, D) in q's dtype, lse (B, H, Tq) fp32.  Launches the CUDA
    kernel for CUDA tensors and runs the plain version for CPU tensors.
    The kernel takes float32, bfloat16 or float16 q, k and v of one dtype,
    D <= 256 (zero-padded to 64, 128, 192 or 256 here, by a copy) and
    strided views with D contiguous and 16-byte aligned strides and base,
    read in place; it raises on anything else."""
    _check_bshd("flash_attention_bshd_fwd", q, k, v)
    if _on_meta((q, k, v)):
        B, Tq, H, _ = q.shape
        return torch.empty_like(q), torch.empty((B, H, Tq),
                                                dtype=torch.float32,
                                                device=q.device)
    device, code = _kernel_operands("flash_attention_bshd_fwd", (q, k, v),
                                    contiguous=False)
    if code is None:
        return _flash_attention_bshd_plain(q, k, v, causal, scale, kv_lens)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    Dp = _padded_head_dim("flash_attention_bshd_fwd", D)
    scale = D ** -0.5 if scale is None else scale
    if Dp != D:
        pad = (0, Dp - D)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    o = torch.empty((B, Tq, H, Dp), dtype=q.dtype, device=device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=device)
    strides = _bshd_strides("flash_attention_bshd_fwd", (q, k, v, o))
    lens = _mask_operands(B, device, kv_lens, None, None)[0]
    fn = _kernel_fn("bshd_fwd")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), None if lens is None else lens.data_ptr(),
                B, H, Tq, Tk, Dp, strides, float(scale), int(bool(causal)),
                code, stream)
    if rc != 0:
        raise MXNetError("flash_attention_bshd_fwd: kernel launch failed "
                         "with CUDA error %d" % rc)
    _count(bshd=True)
    return (o if Dp == D else o[..., :D]), lse


def flash_attention_bshd_bwd(q, k, v, o, lse, do, causal=False, scale=None,
                             kv_lens=None, out=None):
    """``(dq, dk, dv)`` of :func:`flash_attention_bshd_fwd` from its ``o``
    and ``lse`` and the cotangent ``do``, in (B, T, H, D) and the dtypes of
    q, k and v; written into the three tensors ``out`` where given (views
    of one (B, T, 3 H D) gradient, say), which are returned.  Launches the
    CUDA backward for CUDA tensors and runs the plain version for CPU
    tensors.  The operands and ``out`` as the forward takes them, and a
    contiguous float32 lse; raises on anything else."""
    _check_bshd("flash_attention_bshd_bwd", q, k, v, o, do)
    if lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError("flash_attention_bshd_bwd: lse (B, H, Tq), got %s"
                         % (tuple(lse.shape),))
    if out is not None and (out[0].shape != q.shape
                            or out[1].shape != k.shape
                            or out[2].shape != v.shape):
        raise ValueError("flash_attention_bshd_bwd: out takes the shapes of "
                         "q, k and v")
    device, code = _kernel_operands("flash_attention_bshd_bwd",
                                    (q, k, v, o, do), contiguous=False)
    if code is None:
        grads = _flash_attention_bshd_bwd_plain(q, k, v, o, lse, do, causal,
                                                scale, kv_lens)
        if out is None:
            return grads
        for dst, g in zip(out, grads):
            dst.copy_(g)
        return tuple(out)
    if lse.device != device or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise MXNetError("flash_attention_bshd_bwd: the CUDA kernel takes a "
                         "contiguous float32 lse on the operands' device")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    Dp = _padded_head_dim("flash_attention_bshd_bwd", D)
    scale = D ** -0.5 if scale is None else scale
    if Dp != D:
        pad = (0, Dp - D)
        q, k, v, o, do = (torch.nn.functional.pad(t, pad)
                          for t in (q, k, v, o, do))
    if out is not None and Dp == D:
        if any(t.dtype != q.dtype or t.device != device for t in out):
            raise MXNetError("flash_attention_bshd_bwd: out takes q's dtype "
                             "and device")
        dq, dk, dv = out
    else:
        dq = torch.empty((B, Tq, H, Dp), dtype=q.dtype, device=device)
        dk, dv = (torch.empty((B, Tk, H, Dp), dtype=q.dtype, device=device)
                  for _ in range(2))
    strides = _bshd_strides("flash_attention_bshd_bwd",
                            (q, k, v, o, do, dq, dk, dv))
    delta = torch.empty(2 * B * H * (-(-Tq // 64) * 64), dtype=torch.float32,
                        device=device)
    lens = _mask_operands(B, device, kv_lens, None, None)[0]
    fn = _kernel_fn("bshd_bwd")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                None if lens is None else lens.data_ptr(), B, H, Tq, Tk, Dp,
                strides, float(scale), int(bool(causal)), code, stream)
    if rc != 0:
        raise MXNetError("flash_attention_bshd_bwd: kernel launch failed "
                         "with CUDA error %d" % rc)
    _count(backward=True, bshd=True)
    if Dp == D:
        return dq, dk, dv
    grads = dq[..., :D], dk[..., :D], dv[..., :D]
    if out is None:
        return grads
    for dst, g in zip(out, grads):
        dst.copy_(g)
    return tuple(out)


class _FlashAttentionBSHDFunction(torch.autograd.Function):
    """The (B, T, H, D) pair as one Function: forward
    :func:`flash_attention_bshd_fwd`, which saves q, k, v, o and lse;
    backward :func:`flash_attention_bshd_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_lens):
        o, lse = flash_attention_bshd_fwd(q, k, v, causal, scale, kv_lens)
        ctx.save_for_backward(q, k, v, o, lse, kv_lens)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_lens = ctx.saved_tensors
        dq, dk, dv = flash_attention_bshd_bwd(
            q, k, v, o, lse, _bshd_operand(do), ctx.causal, ctx.scale,
            kv_lens)
        return dq, dk, dv, None, None, None


def flash_attention_bshd(q, k, v, causal=False, scale=None, kv_lens=None):
    """Masked attention over (B, T, H, D) operands, the layout a
    projection writes, through the kernels (:func:`flash_attention_bshd_fwd`
    and, where a gradient is recorded, :func:`flash_attention_bshd_bwd`),
    or, for short sequences, the composed attention over transposed views,
    as :func:`attention_dispatch` decides.  The same function as
    :func:`flash_attention` on the transposed operands; no segment ids."""
    plan = attention_dispatch(q.shape[1], k.shape[1], q.shape[3], q.dtype)
    if plan["kernel"] == "dense_fallback":
        return _bhtd(_composed_attention(_bhtd(q), _bhtd(k), _bhtd(v),
                                         causal, scale, kv_lens))
    return _FlashAttentionBSHDFunction.apply(
        _bshd_operand(q), _bshd_operand(k), _bshd_operand(v), causal, scale,
        kv_lens)


def _qkv_heads(qkv, heads):
    """q, k and v of a fused (B, L, 3E) projection output, its three
    column blocks, as (B, L, heads, E / heads) views."""
    E = qkv.shape[-1] // 3
    return tuple(qkv[..., i * E:(i + 1) * E].unflatten(-1, (heads, -1))
                 for i in range(3))


class _SelfAttentionBSHDFunction(torch.autograd.Function):
    """Self-attention over a fused (B, L, 3E) projection output through
    the (B, T, H, D) kernels: the forward reads q, k and v in place as its
    column blocks and returns o as (B, L, E); the backward writes dq, dk
    and dv through their strides into one (B, L, 3E) gradient."""

    @staticmethod
    def forward(ctx, qkv, heads, causal, kv_lens):
        o, lse = flash_attention_bshd_fwd(*_qkv_heads(qkv, heads), causal,
                                          None, kv_lens)
        ctx.save_for_backward(qkv, o, lse, kv_lens)
        ctx.heads, ctx.causal = heads, causal
        return o.reshape(qkv.shape[0], qkv.shape[1], -1)

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse, kv_lens = ctx.saved_tensors
        # do is the gradient of the output projection's input, (B, L, E)
        # and contiguous: the kernels check the strides they take
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        flash_attention_bshd_bwd(*_qkv_heads(qkv, ctx.heads), o, lse,
                                 do.unflatten(-1, o.shape[2:]), ctx.causal,
                                 None, kv_lens,
                                 out=_qkv_heads(dqkv, ctx.heads))
        return dqkv, None, None, None


def self_attention_bshd(qkv, heads, causal=False, kv_lens=None):
    """Multi-head self-attention over a fused (B, L, 3E) projection output
    whose column blocks are q, k and v, ``heads`` heads of E / heads:
    returns o (B, L, E).  Through the (B, T, H, D) kernels, or for L < 128
    the composed attention, as :func:`attention_dispatch` decides."""
    B, L = qkv.shape[:2]
    q, k, v = _qkv_heads(qkv, heads)
    plan = attention_dispatch(L, L, q.shape[3], qkv.dtype)
    if plan["kernel"] == "dense_fallback":
        return _bhtd(_composed_attention(_bhtd(q), _bhtd(k), _bhtd(v),
                                         causal, None, kv_lens)
                     ).reshape(B, L, -1)
    return _SelfAttentionBSHDFunction.apply(qkv, heads, causal, kv_lens)


@register("_contrib_flash_attention", aliases=("flash_attention",))
def _flash_attention_op(queries, keys, values, causal: bool = False,
                        scale: Optional[float] = None, kv_lens=None,
                        q_segments=None, kv_segments=None):
    """Fused multi-head attention op over (B, H, T, D) operands.  The mask
    operands follow causal/scale, as in the JAX package."""
    return flash_attention(queries, keys, values, causal, scale, kv_lens,
                           q_segments, kv_segments)


@register("_contrib_flash_attention_bshd", aliases=("flash_attention_bshd",))
def _flash_attention_bshd_op(queries, keys, values, causal: bool = False,
                             scale: Optional[float] = None, kv_lens=None):
    """Fused multi-head attention over (B, T, H, D) operands (see
    :func:`flash_attention_bshd`)."""
    return flash_attention_bshd(queries, keys, values, causal, scale,
                                kv_lens)
