"""Fused BatchNorm -> residual add -> ReLU epilogue: the kernels' wrappers,
their plain PyTorch versions and the ``torch.autograd.Function`` that joins
forward and backward.

Counterpart of ``mxnet_tpu/ops/pallas_fused_norm.py``.  The epilogue works
on BatchNorm's folded form, per-channel fp32
``scale = rsqrt(var + eps) * gamma`` and ``shift = beta - mean * scale``:

    y = relu(x * scale[c] + shift[c] + residual)

in fp32 with ``y`` in x's dtype.  Its backward, from x, y and the
cotangent ``ct``:

    g = ct * [y > 0];  dx = g * scale[c];  dresidual = g;
    dscale[c] = sum g * x;  dshift[c] = sum g

:func:`fused_bn_add_relu_epilogue` is differentiable in all four operands:
torch carries ``dscale``/``dshift`` on through the folded batch statistics
into the data, gamma and beta.  On CUDA tensors its forward and backward
launch the hand-written kernels in ``csrc/fused_norm.cu`` (float32,
bfloat16 or float16) or raise; on CPU tensors they run the plain versions.  Both
kernels take the per-channel vectors as they are, with the channel count
and the number of trailing elements after the channel axis, so NCHW and
NHWC need no transpose and no repeated scale/shift in device memory.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError

__all__ = ["fused_bn_add_relu_epilogue", "fused_bn_add_relu_epilogue_plain",
           "fused_bn_add_relu_epilogue_bwd",
           "fused_bn_add_relu_epilogue_bwd_plain",
           "fused_scale_shift_add_relu", "LAUNCHES", "BWD_LAUNCHES"]

# kernel launches in this process: forward (fused_bn_add_relu_epilogue's
# kernel) and backward (fused_bn_add_relu_epilogue_bwd's kernel)
LAUNCHES = 0
BWD_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FNS = {}


def _kernel_fns():
    """The library's (forward, backward, backward workspace) functions."""
    if not _FNS:
        from .. import kernels
        lib = kernels.load("fused_norm")
        fwd = lib.mx_fused_bn_add_relu_fwd
        fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + \
            [ctypes.c_int, ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd = lib.mx_fused_bn_add_relu_bwd
        bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4 + \
            [ctypes.c_int, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        ws = lib.mx_fused_bn_add_relu_bwd_workspace
        ws.argtypes = [ctypes.c_longlong] * 3
        ws.restype = ctypes.c_longlong
        _FNS.update(fwd=fwd, bwd=bwd, ws=ws)
    return _FNS


def _count(forward: bool):
    global LAUNCHES, BWD_LAUNCHES
    with _COUNT_LOCK:
        if forward:
            LAUNCHES += 1
        else:
            BWD_LAUNCHES += 1


def _channel_layout(data, scale, axis, *same_shape):
    """(axis, C, trail) after checking shapes; raises on a mismatch."""
    for t in same_shape:
        if tuple(t.shape) != tuple(data.shape):
            raise ValueError("operand shape %r must match data shape %r"
                             % (tuple(t.shape), tuple(data.shape)))
    axis = axis % data.dim()
    C = data.shape[axis]
    if scale.numel() != C:
        raise ValueError("per-channel vectors need %d entries, got %d"
                         % (C, scale.numel()))
    trail = 1
    for d in data.shape[axis + 1:]:
        trail *= d
    return axis, C, trail


def _device_of(name, tensors, meta=False):
    """The one device of ``tensors``: raises when they are on several, or
    on a device that is neither the CPU nor CUDA (nor, where ``meta``,
    the ``meta`` device of shape inference)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise MXNetError("%s: operands on several devices %s"
                         % (name, sorted(map(str, devices))))
    device = devices.pop()
    if device.type not in ("cpu", "cuda") + (("meta",) if meta else ()):
        raise MXNetError("%s: no kernel for device %s" % (name, device))
    return device


def _kernel_dtype(name, x, *same):
    code = _DTYPE_CODE.get(x.dtype)
    if code is None or any(t.dtype != x.dtype for t in same):
        raise MXNetError("%s: the CUDA kernel takes float32, bfloat16 or "
                         "float16 operands of one dtype, got %s"
                         % (name, [str(t.dtype) for t in (x,) + same]))
    return code


def _compute_dtype(dtype):
    """fp32 for float32 and narrower inputs, float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _bcast(v, axis, dim, dtype):
    shp = [1] * dim
    shp[axis] = v.numel()
    return v.to(dtype).reshape(shp)


def fused_bn_add_relu_epilogue_plain(data, scale, shift, residual, axis):
    """The plain PyTorch forward: the same function in the same order of
    operations as the kernel, in fp32 (float64 for float64 inputs)."""
    axis, C, _ = _channel_layout(data, scale, axis, residual)
    cdt = _compute_dtype(data.dtype)
    y = data.to(cdt) * _bcast(scale, axis, data.dim(), cdt) \
        + _bcast(shift, axis, data.dim(), cdt) + residual.to(cdt)
    return y.clamp_min(0.0).to(data.dtype)


def fused_bn_add_relu_epilogue_bwd_plain(x, scale, y, ct, axis):
    """The plain PyTorch backward: ``(dx, dresidual, dscale, dshift)``, dx
    and dresidual in x's dtype, dscale and dshift in fp32 (float64 for
    float64 inputs), in the kernel's order of operations except for the
    order of the channel sums."""
    axis, C, _ = _channel_layout(x, scale, axis, y, ct)
    cdt = _compute_dtype(x.dtype)
    g = torch.where(y > 0, ct.to(cdt), torch.zeros((), dtype=cdt,
                                                   device=ct.device))
    dx = (g * _bcast(scale, axis, x.dim(), cdt)).to(x.dtype)
    dims = tuple(i for i in range(x.dim()) if i != axis)
    ds = (g * x.to(cdt)).sum(dim=dims)
    dt = g.sum(dim=dims)
    return dx, g.to(x.dtype), ds, dt


def _fwd_kernel(data, scale, shift, residual, C, trail):
    code = _kernel_dtype("fused_bn_add_relu_epilogue", data, residual)
    x = data.contiguous()
    r = residual.contiguous()
    s = scale.to(torch.float32).contiguous()
    t = shift.to(torch.float32).contiguous()
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    n = x.numel()
    if n == 0:
        return y
    fn = _kernel_fns()["fwd"]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), s.data_ptr(), t.data_ptr(), r.data_ptr(),
                y.data_ptr(), n, C, trail, code, stream)
    if rc != 0:
        raise MXNetError("fused_bn_add_relu_epilogue: kernel launch failed "
                         "with CUDA error %d" % rc)
    _count(True)
    return y


def fused_bn_add_relu_epilogue_bwd(x, scale, y, ct, axis):
    """``(dx, dresidual, dscale, dshift)`` of the epilogue from the
    forward's ``x`` and ``y`` and the cotangent ``ct``.  Launches the CUDA
    kernel for CUDA tensors and runs the plain version for CPU tensors."""
    axis, C, trail = _channel_layout(x, scale, axis, y, ct)
    device = _device_of("fused_bn_add_relu_epilogue_bwd", (x, scale, y, ct))
    if device.type == "cpu":
        return fused_bn_add_relu_epilogue_bwd_plain(x, scale, y, ct, axis)
    code = _kernel_dtype("fused_bn_add_relu_epilogue_bwd", x, y, ct)
    x, y, ct = x.contiguous(), y.contiguous(), ct.contiguous()
    s = scale.to(torch.float32).contiguous()
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    dr = torch.empty_like(x, memory_format=torch.contiguous_format)
    ds = torch.empty(C, dtype=torch.float32, device=device)
    dt = torch.empty(C, dtype=torch.float32, device=device)
    n = x.numel()
    if n == 0:
        return dx, dr, ds.zero_(), dt.zero_()
    fns = _kernel_fns()
    ws_floats = fns["ws"](n, C, trail)
    if ws_floats < 0:
        raise MXNetError("fused_bn_add_relu_epilogue_bwd: bad layout n=%d "
                         "C=%d trail=%d" % (n, C, trail))
    ws = torch.empty(ws_floats, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fns["bwd"](x.data_ptr(), s.data_ptr(), y.data_ptr(),
                        ct.data_ptr(), dx.data_ptr(), dr.data_ptr(),
                        ds.data_ptr(), dt.data_ptr(), ws.data_ptr(),
                        ws_floats, n, C, trail, code, stream)
    if rc != 0:
        raise MXNetError("fused_bn_add_relu_epilogue_bwd: kernel launch "
                         "failed with CUDA error %d" % rc)
    _count(False)
    return dx, dr, ds, dt


def _epilogue_fwd(data, scale, shift, residual, axis, C, trail):
    if data.device.type == "cpu":
        return fused_bn_add_relu_epilogue_plain(data, scale, shift, residual,
                                                axis)
    if data.device.type == "meta":
        # the shape rule of shape inference (Symbol.infer_shape): y has
        # data's shape and dtype, without data; a CUDA tensor never takes it
        return torch.empty_like(data)
    return _fwd_kernel(data, scale, shift, residual, C, trail)


class _Epilogue(torch.autograd.Function):
    """Forward kernel (or plain forward) and backward kernel (or plain
    backward) as one differentiable function of (data, scale, shift,
    residual).  It keeps x, scale and y for the backward, not the
    residual: the ReLU mask comes from y."""

    @staticmethod
    def forward(ctx, data, scale, shift, residual, axis, C, trail):
        y = _epilogue_fwd(data, scale, shift, residual, axis, C, trail)
        ctx.save_for_backward(data, scale, y)
        ctx.axis = axis
        ctx.dtypes = (scale.dtype, shift.dtype, residual.dtype)
        return y

    @staticmethod
    def backward(ctx, ct):
        x, scale, y = ctx.saved_tensors
        dx, dr, ds, dt = fused_bn_add_relu_epilogue_bwd(x, scale, y, ct,
                                                        ctx.axis)
        s_dt, t_dt, r_dt = ctx.dtypes
        return dx, ds.to(s_dt), dt.to(t_dt), dr.to(r_dt), None, None, None


def fused_bn_add_relu_epilogue(data, scale, shift, residual, axis):
    """``relu(data * scale[c] + shift[c] + residual)`` with the per-channel
    vectors broadcast on ``axis``, differentiable in all four operands.
    Launches the CUDA kernels for CUDA tensors and runs the plain versions
    for CPU tensors."""
    axis, C, trail = _channel_layout(data, scale, axis, residual)
    if shift.numel() != C:
        raise ValueError("per-channel vectors need %d entries, got %d"
                         % (C, shift.numel()))
    operands = (data, scale, shift, residual)
    _device_of("fused_bn_add_relu_epilogue", operands, meta=True)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _Epilogue.apply(data, scale, shift, residual, axis, C, trail)
    # no graph to record (serving, inference mode): the Function's
    # bookkeeping would cost more host time than the launch itself
    return _epilogue_fwd(data, scale, shift, residual, axis, C, trail)


def fused_scale_shift_add_relu(x2d, scale, shift, r2d):
    """The 2-D entry of the JAX package: per-column scale/shift over
    ``(rows, cols)`` operands, i.e. the N-D entry with ``trail = 1``."""
    return fused_bn_add_relu_epilogue(x2d, scale, shift, r2d, 1)
