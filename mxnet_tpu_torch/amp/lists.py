"""AMP op lists.

The port's own copy of ``mxnet_tpu/amp/lists.py`` (reference:
``python/mxnet/contrib/amp/lists/symbol_fp16.py``), with the same names and
the same entries: TARGET_DTYPE_OPS (always narrow), FP32_OPS (always
wide), WIDEST_TYPE_CASTS (match the widest floating input) and
CONDITIONAL_FP32_OPS (wide for particular attribute values).  The lists
name registered ops by their registered name; an op in no list runs in
whatever dtype its inputs carry.  A name the port does not register yet
(``RNN``, ``CTCLoss``, ...) is kept, so the lists stay the reference's.
"""

# matrix-product ops: always cast floating inputs down to the target dtype,
# where the tensor cores run at twice the fp32 rate or more
TARGET_DTYPE_OPS = [
    "Convolution", "Deconvolution", "FullyConnected", "RNN",
    "dot", "batch_dot", "einsum",
    "linalg_gemm", "linalg_gemm2",
    "multi_head_attention",
    "_contrib_interleaved_matmul_encdec_qk",
    "_contrib_interleaved_matmul_encdec_valatt",
    "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt",
]

# Numerically sensitive ops: always promote narrow float inputs to fp32
# (softmax/log/exp accumulate in ways that overflow/cancel in 8-bit-mantissa
# bf16; norms divide by small variances).
FP32_OPS = [
    "softmax", "log_softmax", "softmin", "masked_softmax",
    "masked_log_softmax", "softmax_cross_entropy", "SoftmaxOutput",
    "CTCLoss",
    "BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm", "RMSNorm",
    "L2Normalization", "norm", "moments", "var", "std",
    "exp", "expm1", "log", "log1p", "log2", "log10",
    "erfinv", "gammaln", "digamma", "polygamma", "gammainc", "gammaincc",
    "logsumexp", "cumsum", "cumprod", "linalg_potrf", "linalg_potri",
    "linalg_sumlogdiag", "linalg_det", "linalg_slogdet", "linalg_inverse",
    "linalg_syevd",
]

# Multi-input elementwise ops: if inputs mix float widths, cast all to the
# widest so no operand is truncated.
WIDEST_TYPE_CASTS = [
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_maximum", "broadcast_minimum", "broadcast_power",
    "broadcast_hypot", "broadcast_mod",
    "arctan2", "copysign", "logaddexp", "hypot", "ldexp", "nextafter",
    "where", "lerp", "concat", "stack", "heaviside",
]

# (op_name, param_name, [values]) -> run in fp32 when the attribute matches
# (reference: CONDITIONAL_FP32_FUNCS, e.g. softrelu activation).
CONDITIONAL_FP32_OPS = [
    ("Activation", "act_type", ["softrelu"]),
    ("LeakyReLU", "act_type", ["selu", "elu"]),
]
