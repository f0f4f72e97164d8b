"""Vision models (counterpart of ``mxnet_tpu/gluon/model_zoo/vision``):
the ResNet v1 family and ``get_model`` by name; the other nets come
later."""
from .resnet import *  # noqa: F401,F403
from .resnet import get_resnet, resnet_spec


def get_model(name, **kwargs):
    """A model by name, as the JAX package's ``get_model``:
    ``resnet<depth>_v1`` (and ``_v2``, which raises until it is ported);
    any other name raises ``ValueError``, as an unknown one does in the
    JAX package."""
    name = name.lower()
    for version in (1, 2):
        for depth in resnet_spec:
            if name == "resnet%d_v%d" % (depth, version):
                return get_resnet(version, depth, **kwargs)
    raise ValueError("Model %s is not supported by the port" % name)
