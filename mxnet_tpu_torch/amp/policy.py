"""Autocast policy: which registry ops run in half precision
(counterpart of mxnet_tpu/amp/policy.py, copied name for name).

Three buckets, keyed on the op registry's names (``ops/registry.py``):

  ALLOW  — matmul- and conv-class ops, whose FLOPs dominate a step and
           whose tensor-core rate is far higher in bf16/fp16: float
           inputs are cast DOWN to the amp dtype where the op is called.
           Accumulation stays fp32 inside (cuBLAS, cuDNN, the flash
           kernels' f32 accumulators).
  WIDEN  — numerically fragile reductions: the softmax family, the loss
           heads and every normalization whose statistics must
           accumulate in fp32 (Micikevicius et al. 2018). Float inputs
           are cast UP to fp32.
  (rest) — NEUTRAL: elementwise and shape ops run in whatever dtype
           arrives. Integer inputs (ids, indices, masks) are never cast
           by any bucket.

``LOSS_HEADS`` are the legacy heads whose backward supplies its own
gradient and ignores the incoming cotangent: multiplying the loss by the
fp16 loss scale does not scale the gradients under them, so the scale
is injected into the cotangent just below the head instead
(``amp.cast_op_inputs``). A graph whose loss is an ordinary
differentiable value keeps ``loss * scale`` (``parallel/dp.py``); the
two routes cannot both apply, since scaling a loss above a head that
drops its cotangent does nothing, and the injection fires only on these
ops.
"""
from __future__ import annotations

# compute-bound ops: cast float inputs down to the amp dtype
ALLOW = frozenset({
    "FullyConnected",
    "Convolution",
    "Deconvolution",
    "dot",
    "batch_dot",
    "_linalg_gemm",
    "_linalg_gemm2",
    "_contrib_flash_attention",
})

LOSS_HEADS = frozenset({
    "SoftmaxOutput",
    "LinearRegressionOutput",
    "LogisticRegressionOutput",
    "MAERegressionOutput",
    "MakeLoss",
    "SVMOutput",
})

# reduction/loss/norm ops: cast float inputs up to fp32
WIDEN = frozenset({
    "softmax",
    "log_softmax",
    "SoftmaxActivation",
    "SoftmaxOutput",
    "softmax_cross_entropy",
    "BatchNorm",
    "LayerNorm",
    "InstanceNorm",
    "L2Normalization",
    "LRN",
    "norm",
    "MakeLoss",
    "make_loss",
    "SVMOutput",
    "smooth_l1",
    "IdentityAttachKLSparseReg",
})
