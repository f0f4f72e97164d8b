"""AMP op lists, the port's copy of ``mxnet_tpu/contrib/amp/lists.py``:
which ops run in the low-precision target dtype (the matrix products and
convolutions, on the tensor cores), which stay float32 (reductions,
normalisations, softmax, exponentials), and which follow the widest of
their input dtypes.  An op in no list runs in the dtypes it is given.
"""

# ops cast to the target dtype (the products that run on the tensor cores)
TARGET_DTYPE_OPS = [
    "FullyConnected", "fully_connected",
    "Convolution", "convolution", "Convolution_v1",
    "Deconvolution", "deconvolution",
    "dot", "batch_dot",
    "linalg_gemm", "linalg_gemm2",
    "RNN",
]

# ops forced to float32 (numerically sensitive)
FP32_OPS = [
    "softmax", "log_softmax", "softmin", "SoftmaxActivation",
    "SoftmaxOutput", "softmax_output", "Softmax",
    "softmax_cross_entropy",
    "BatchNorm", "batch_norm", "BatchNorm_v1",
    "LayerNorm", "layer_norm", "InstanceNorm", "GroupNorm", "LRN", "lrn",
    "norm", "L2Normalization",
    "exp", "log", "log2", "log10", "log1p", "expm1",
    "power", "_power_scalar", "rsqrt", "rcbrt", "reciprocal",
    "mean", "sum", "sum_axis", "nansum", "prod", "nanprod",
    "erfinv", "gamma", "gammaln",
    "LinearRegressionOutput", "MAERegressionOutput",
    "LogisticRegressionOutput", "make_loss",
]

# multi-input ops that should promote to the widest input dtype
WIDEST_TYPE_CASTS = [
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_power", "broadcast_maximum", "broadcast_minimum",
    "broadcast_hypot", "elemwise_add", "elemwise_sub", "elemwise_mul",
    "elemwise_div", "where", "maximum", "minimum",
]

# conditionally float32 ops: (op, attribute, values), e.g.
# LeakyReLU(act_type='selu') stays float32
CONDITIONAL_FP32_OPS = [
    ("LeakyReLU", "act_type", ["selu"]),
    ("Activation", "act_type", ["softrelu"]),
]
