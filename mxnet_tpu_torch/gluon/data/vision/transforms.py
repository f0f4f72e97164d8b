"""Vision transforms on HWC images (uint8 or float), as Blocks.

Counterpart of ``mxnet_tpu/gluon/data/vision/transforms.py`` for the
transforms that do not resize: ``Compose``, ``Cast``, ``ToTensor`` (HWC
[0, 255] to CHW float32 in [0, 1]), ``Normalize``, ``CenterCrop`` of an
image at least the crop's size, both random flips, brightness, contrast,
saturation, PCA lighting and ``RandomColorJitter``.  The random ones draw
from Python's ``random`` and numpy's global generator in the JAX
package's order, so seeded runs of the two agree exactly; their math runs
in numpy and the result is an NDArray on the current context.
``Resize``, ``RandomResizedCrop`` and ``CenterCrop``'s upscale call
OpenCV's resize in the JAX package and wait with ``image``'s ``imresize``
(ROADMAP.md, queue 1, item 7): they raise ``MXNetError``.
"""
from __future__ import annotations

import random

import numpy as onp
import torch

from ....base import MXNetError
from ....ndarray import NDArray, array
from ....ndarray.ndarray import _wrap
from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomLighting", "RandomColorJitter"]


def _waits(what):
    return MXNetError("%s resizes with OpenCV, which is not ported yet: it "
                      "waits with image's imresize (ROADMAP.md, queue 1, "
                      "item 7)" % what)


def _numpy(x):
    return x.asnumpy() if isinstance(x, NDArray) else onp.asarray(x)


def _nd(x):
    return x if isinstance(x, NDArray) else array(onp.asarray(x),
                                                  dtype=onp.asarray(x).dtype)


class Compose(Sequential):
    """The transforms one after another."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    """The image cast to ``dtype``."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return _nd(x).astype(self._dtype)


class ToTensor(HybridBlock):
    """HWC (or NHWC) [0, 255] to CHW (NCHW) float32 in [0, 1]."""

    def hybrid_forward(self, F, x):
        v = _nd(x)._data.to(torch.float32) / 255.0
        if v.dim() == 3:
            return _wrap(v.permute(2, 0, 1))
        return _wrap(v.permute(0, 3, 1, 2))


class Normalize(HybridBlock):
    """``(x - mean) / std``, per channel of a CHW (NCHW) image where
    ``mean`` and ``std`` are sequences."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def hybrid_forward(self, F, x):
        v = _nd(x)._data
        mean = torch.as_tensor(self._mean, dtype=v.dtype, device=v.device)
        std = torch.as_tensor(self._std, dtype=v.dtype, device=v.device)
        if mean.dim() == 1:
            shape = (-1,) + (1,) * (v.dim() - 1 - (v.dim() == 4))
            mean = mean.reshape(shape)
            std = std.reshape(shape)
        return _wrap((v - mean) / std)


class Resize(Block):
    """Resize an HWC image; waits (see the module's note)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        raise _waits("Resize")


class CenterCrop(Block):
    """The central ``size`` (width, height) of an HWC image at least that
    large; a smaller image would be scaled up first, which waits."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._interpolation = interpolation

    def forward(self, x):
        img = _numpy(x)
        h, w = img.shape[:2]
        cw, ch = self._size
        if h < ch or w < cw:
            raise _waits("CenterCrop of an image smaller than the crop")
        y0 = (h - ch) // 2
        x0 = (w - cw) // 2
        return array(img[y0:y0 + ch, x0:x0 + cw], dtype=img.dtype)


class RandomResizedCrop(Block):
    """A random crop resized to ``size``; waits (see the module's
    note)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        raise _waits("RandomResizedCrop")


class RandomFlipLeftRight(Block):
    """The image flipped left to right with probability 1/2."""

    def forward(self, x):
        if random.random() < 0.5:
            img = _numpy(x)
            return array(img[:, ::-1].copy(), dtype=img.dtype)
        return x


class RandomFlipTopBottom(Block):
    """The image flipped top to bottom with probability 1/2."""

    def forward(self, x):
        if random.random() < 0.5:
            img = _numpy(x)
            return array(img[::-1].copy(), dtype=img.dtype)
        return x


class _RandomColorBase(Block):
    def __init__(self, amount):
        super().__init__()
        self._amount = amount

    def _alpha(self):
        return 1.0 + random.uniform(-self._amount, self._amount)


class RandomBrightness(_RandomColorBase):
    """The image times ``1 + U(-brightness, brightness)``."""

    def forward(self, x):
        img = _numpy(x).astype("float32")
        return array(img * self._alpha(), dtype="float32")


class RandomContrast(_RandomColorBase):
    """The image blended with its mean gray level."""

    def forward(self, x):
        img = _numpy(x).astype("float32")
        coef = onp.array([0.299, 0.587, 0.114], "float32")
        alpha = self._alpha()
        gray = (img * coef).sum(axis=-1, keepdims=True).mean()
        return array(img * alpha + gray * (1 - alpha), dtype="float32")


class RandomSaturation(_RandomColorBase):
    """The image blended with its own gray image."""

    def forward(self, x):
        img = _numpy(x).astype("float32")
        coef = onp.array([0.299, 0.587, 0.114], "float32")
        alpha = self._alpha()
        gray = (img * coef).sum(axis=-1, keepdims=True)
        return array(img * alpha + gray * (1 - alpha), dtype="float32")


class RandomLighting(Block):
    """AlexNet's PCA lighting noise, its three weights drawn from numpy's
    global generator."""

    _eigval = onp.array([55.46, 4.794, 1.148], "float32")
    _eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], "float32")

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        img = _numpy(x).astype("float32")
        alpha = onp.random.normal(0, self._alpha, 3).astype("float32")
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return array(img + rgb, dtype="float32")


class RandomColorJitter(Block):
    """Brightness, contrast and saturation jitter, in an order drawn
    anew for each image."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))

    def forward(self, x):
        ts = list(self._ts)
        random.shuffle(ts)
        for t in ts:
            x = t.forward(x)
        return x
