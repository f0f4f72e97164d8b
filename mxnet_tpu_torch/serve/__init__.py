"""``mxnet_tpu_torch.serve`` — continuous-batching inference (counterpart
of ``mxnet_tpu/serve``): a bucket menu warmed up at start, a bounded
request queue with dynamic batching, per-request deadlines, admission
control, a hung-dispatch watchdog with bucket quarantine, and the
``STARTING -> READY -> DEGRADED -> DRAINING`` health states."""
from .buckets import AotModel, pad_batch, pick_bucket, plan_buckets
from .server import (DEGRADED, DRAINING, READY, STARTING,
                     InferenceServer, PendingRequest, ServeConfig,
                     ServeError, ServeRejected, ServeTimeout)

__all__ = [
    "AotModel", "pad_batch", "pick_bucket", "plan_buckets",
    "InferenceServer", "PendingRequest", "ServeConfig",
    "ServeError", "ServeRejected", "ServeTimeout",
    "STARTING", "READY", "DEGRADED", "DRAINING",
]
