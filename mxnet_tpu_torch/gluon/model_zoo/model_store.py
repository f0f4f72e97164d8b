"""Model weight store (counterpart of
``mxnet_tpu/gluon/model_zoo/model_store.py``).

No pretrained weights ship with this repository and nothing is
downloaded: ``get_model_file`` resolves ``<name>.params`` under
``$MXNET_HOME/models`` (default ``~/.mxnet/models``) and raises when the
file is not there.
"""
import os

__all__ = ["get_model_file"]


def _model_dir(root):
    if root is None:
        root = os.path.join(
            os.environ.get("MXNET_HOME", os.path.join("~", ".mxnet")),
            "models")
    return os.path.expanduser(root)


def get_model_file(name, root=None):
    """The local path of the pretrained parameter file ``name``."""
    file_path = os.path.join(_model_dir(root), name + ".params")
    if os.path.exists(file_path):
        return file_path
    raise FileNotFoundError(
        "Pretrained weights for %r not found at %s; none ship with this "
        "build and nothing is downloaded." % (name, file_path))
