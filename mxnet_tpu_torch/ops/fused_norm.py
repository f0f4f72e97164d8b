"""Fused BatchNorm -> residual add -> ReLU epilogue: the kernel's wrapper
and its plain PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas_fused_norm.py`` (forward only; the
backward kernel and the ``torch.autograd.Function`` come with training).
The epilogue works on BatchNorm's folded form, per-channel fp32
``scale = rsqrt(var + eps) * gamma`` and ``shift = beta - mean * scale``:

    y = relu(x * scale[c] + shift[c] + residual)

in fp32 with ``y`` in x's dtype.  On a CUDA tensor
:func:`fused_bn_add_relu_epilogue` launches the hand-written kernel in
``csrc/fused_norm.cu`` (float32 or bfloat16) or raises; on a CPU tensor
it runs :func:`fused_bn_add_relu_epilogue_plain`.  The kernel takes the
per-channel vectors as they are, with the channel count and the number of
trailing elements after the channel axis, so NCHW and NHWC need no
transpose and no repeated scale/shift in device memory.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError

__all__ = ["fused_bn_add_relu_epilogue", "fused_bn_add_relu_epilogue_plain",
           "fused_scale_shift_add_relu", "LAUNCHES"]

# kernel launches made by fused_bn_add_relu_epilogue in this process
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = []


def _kernel_fn():
    if not _FN:
        from .. import kernels
        fn = kernels.load("fused_norm").mx_fused_bn_add_relu_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + \
            [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def _channel_layout(data, scale, shift, residual, axis):
    """(axis, C, trail) after checking shapes; raises on a mismatch."""
    if tuple(residual.shape) != tuple(data.shape):
        raise ValueError("residual shape %r must match data shape %r"
                         % (tuple(residual.shape), tuple(data.shape)))
    axis = axis % data.dim()
    C = data.shape[axis]
    if scale.numel() != C or shift.numel() != C:
        raise ValueError("scale/shift need %d entries, got %d/%d"
                         % (C, scale.numel(), shift.numel()))
    trail = 1
    for d in data.shape[axis + 1:]:
        trail *= d
    return axis, C, trail


def fused_bn_add_relu_epilogue_plain(data, scale, shift, residual, axis):
    """The plain PyTorch version: the same function, in the same fp32 order
    of operations as the kernel."""
    axis, C, _ = _channel_layout(data, scale, shift, residual, axis)
    shp = [1] * data.dim()
    shp[axis] = C
    y = data.float() * scale.float().reshape(shp) \
        + shift.float().reshape(shp) + residual.float()
    return y.clamp_min(0.0).to(data.dtype)


def fused_bn_add_relu_epilogue(data, scale, shift, residual, axis):
    """``relu(data * scale[c] + shift[c] + residual)`` with the per-channel
    vectors broadcast on ``axis``.  Launches the CUDA kernel for CUDA
    tensors and runs the plain version for CPU tensors."""
    global LAUNCHES
    axis, C, trail = _channel_layout(data, scale, shift, residual, axis)
    tensors = (data, scale, shift, residual)
    if any(t.requires_grad for t in tensors):
        raise MXNetError("fused_bn_add_relu_epilogue has no backward yet: "
                         "call it on tensors that do not require grad")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise MXNetError("fused_bn_add_relu_epilogue: operands on several "
                         "devices %s" % sorted(map(str, devices)))
    device = data.device
    if device.type == "cpu":
        return fused_bn_add_relu_epilogue_plain(data, scale, shift, residual,
                                                axis)
    if device.type != "cuda":
        raise MXNetError("fused_bn_add_relu_epilogue: no kernel for device %s"
                         % device)
    code = _DTYPE_CODE.get(data.dtype)
    if code is None or residual.dtype != data.dtype:
        raise MXNetError("fused_bn_add_relu_epilogue: data/residual must both "
                         "be float32 or bfloat16, got %s/%s"
                         % (data.dtype, residual.dtype))
    x = data.contiguous()
    r = residual.contiguous()
    s = scale.to(torch.float32).contiguous()
    t = shift.to(torch.float32).contiguous()
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    n = x.numel()
    if n == 0:
        return y
    fn = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(x.data_ptr(), s.data_ptr(), t.data_ptr(), r.data_ptr(),
                y.data_ptr(), n, C, trail, code, stream)
    if rc != 0:
        raise MXNetError("fused_bn_add_relu_epilogue: kernel launch failed "
                         "with CUDA error %d" % rc)
    with _COUNT_LOCK:
        LAUNCHES += 1
    return y


def fused_scale_shift_add_relu(x2d, scale, shift, r2d):
    """The 2-D entry of the JAX package: per-column scale/shift over
    ``(rows, cols)`` operands, i.e. the N-D entry with ``trail = 1``."""
    return fused_bn_add_relu_epilogue(x2d, scale, shift, r2d, 1)
