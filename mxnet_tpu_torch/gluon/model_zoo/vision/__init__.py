"""Vision models (counterpart of ``mxnet_tpu/gluon/model_zoo/vision``):
the ResNet v1 family; the other nets and ``get_model`` come later."""
from .resnet import *  # noqa: F401,F403
