"""``mx.mod``: the Module training API (counterpart of
``mxnet_tpu/module/``)."""
from .base_module import BaseModule  # noqa: F401
from .module import Module  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
from .sequential_module import SequentialModule  # noqa: F401

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule"]
