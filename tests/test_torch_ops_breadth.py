"""The port's loss heads and layers (ops/nn.py), its tensor ops
(ops/tensor.py) and long-tail ops (ops/extra.py) against the JAX
package's, on the CPU: each op's registered fcompute is given the same
seeded numpy inputs and attrs in both packages, and its outputs and its
vector-Jacobian product (a seeded cotangent for every float output)
compared, as cases of one parametrised test. Outputs and gradients are
held within RTOL of each tensor's largest magnitude (plus ATOL);
integer outputs (indices, shapes) exactly. The legacy loss heads drop
the cotangent in both packages (their gradient is the implied loss's).

Then the registry: the port has every op of the JAX package's, under
the same names and aliases.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu  # noqa: F401  (registers the JAX ops)
import mxnet_tpu_torch  # noqa: F401
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6


def _r(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _spd(seed, n):
    a = _r(seed, n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _lower(seed, n):
    a = np.tril(_r(seed, n, n))
    return (a + 2 * np.eye(n) * np.sign(np.diag(a) + 1e-3)).astype(
        np.float32)


def _idx(seed, hi, *shape):
    return np.random.RandomState(seed).randint(0, hi, shape) \
        .astype(np.float32)


def _rois(seed, n, batch, h=24, w=32):
    """(n, 5) rois [batch index, x1, y1, x2, y2] in an h x w image, some
    past its edges (in image pixels: spatial_scale maps them)."""
    rng = np.random.RandomState(seed)
    x = np.sort(rng.uniform(-2, w + 2, (n, 2)), axis=1)
    y = np.sort(rng.uniform(-2, h + 2, (n, 2)), axis=1)
    b = rng.randint(0, batch, (n, 1))
    return np.concatenate([b, x[:, :1], y[:, :1], x[:, 1:], y[:, 1:]],
                          axis=1).astype(np.float32)


def _rpn_probs(seed, b, a, h, w):
    """(b, 2a, h, w): each anchor's (background, foreground) softmax
    pair, background channels first (the RPN's layout)."""
    z = np.random.RandomState(seed).standard_normal((b, 2, a, h, w))
    p = np.exp(z) / np.exp(z).sum(1, keepdims=True)
    return p.reshape(b, 2 * a, h, w).astype(np.float32)


_TIES = np.array([[3., 1., 3., 2., 1., 3.], [0., 0., 5., 5., 4., 0.]],
                 np.float32)
# inputs on the kinks: 0 and -0.0 (relu, abs), the clip bounds -1 and 2,
# the scalar 0.5
_KINKS = np.array([[-1., 0., -0., 0.5, 2., -2.], [0.5, 3., 0., -1., 0.25,
                                                   2.]], np.float32)
_NANS = np.array([[0.5, np.nan, -1.], [np.nan, 2., 0.25]], np.float32)

# (case id, op, inputs, attrs, indices of the inputs differentiated)
CASES = [
    # ops/nn.py: loss heads and layers
    ("MakeLoss", "MakeLoss", [_r(0, 4, 5)], {}, [0]),
    ("MakeLoss_batch", "MakeLoss", [_r(1, 4, 5)],
     {"normalization": "batch", "grad_scale": 2.0}, [0]),
    ("MakeLoss_valid", "MakeLoss", [_r(2, 4, 5)],
     {"normalization": "valid", "valid_thresh": 0.1}, [0]),
    ("LinearRegressionOutput", "LinearRegressionOutput",
     [_r(3, 4, 3), _r(4, 4, 3)], {"grad_scale": 0.5}, [0]),
    ("LogisticRegressionOutput", "LogisticRegressionOutput",
     [_r(5, 4, 3), _r(6, 4, 3, lo=0.0)], {}, [0]),
    ("MAERegressionOutput", "MAERegressionOutput",
     [_r(7, 4, 3), _r(8, 4, 3)], {}, [0]),
    ("SVMOutput", "SVMOutput", [_r(9, 5, 4), _idx(10, 4, 5)],
     {"margin": 0.5}, [0]),
    ("SVMOutput_linear", "SVMOutput", [_r(11, 5, 4), _idx(12, 4, 5)],
     {"use_linear": True, "regularization_coefficient": 0.3}, [0]),
    ("SoftmaxActivation", "SoftmaxActivation", [_r(13, 2, 3, 4)], {}, [0]),
    ("SoftmaxActivation_channel", "SoftmaxActivation", [_r(14, 2, 3, 4)],
     {"mode": "channel"}, [0]),
    ("L2Normalization", "L2Normalization", [_r(15, 2, 3, 4, 5)], {}, [0]),
    ("L2Normalization_channel", "L2Normalization", [_r(16, 2, 3, 4, 5)],
     {"mode": "channel"}, [0]),
    ("L2Normalization_spatial", "L2Normalization", [_r(17, 2, 3, 4, 5)],
     {"mode": "spatial", "eps": 1e-5}, [0]),
    ("LRN", "LRN", [_r(18, 2, 7, 3, 4)],
     {"nsize": 5, "alpha": 0.01, "beta": 0.75, "knorm": 2.0}, [0]),
    ("UpSampling_nearest", "UpSampling", [_r(19, 2, 3, 4, 5)],
     {"scale": 2, "sample_type": "nearest"}, [0]),
    ("UpSampling_bilinear", "UpSampling", [_r(20, 2, 3, 4, 5)],
     {"scale": 2, "sample_type": "bilinear"}, [0]),
    # ops/tensor.py
    ("make_loss", "make_loss", [_r(21, 3, 4)], {}, [0]),
    ("smooth_l1", "smooth_l1", [_r(22, 3, 8, lo=-3, hi=3)],
     {"scalar": 1.5}, [0]),
    ("hard_sigmoid", "hard_sigmoid", [_r(23, 3, 8, lo=-4, hi=4)],
     {"alpha": 0.3, "beta": 0.4}, [0]),
    ("div_sqrt_dim", "_contrib_div_sqrt_dim", [_r(24, 2, 3, 16)], {}, [0]),
    ("sort", "sort", [_r(25, 3, 6)], {}, [0]),
    ("sort_desc_axis0", "sort", [_r(26, 5, 4)],
     {"axis": 0, "is_ascend": False}, [0]),
    ("argsort_ties", "argsort", [_TIES], {}, []),
    ("argsort_desc_ties", "argsort", [_TIES],
     {"is_ascend": False, "dtype": "int32"}, []),
    ("topk_ties", "topk", [_TIES], {"k": 3}, []),
    ("topk_value", "topk", [_r(27, 3, 7)], {"k": 2, "ret_typ": "value"},
     [0]),
    ("topk_both_asc_axis0", "topk", [_r(28, 6, 3)],
     {"k": 2, "ret_typ": "both", "is_ascend": True, "axis": 0}, [0]),
    ("topk_mask", "topk", [_TIES], {"k": 2, "ret_typ": "mask"}, []),
    ("tile", "tile", [_r(29, 2, 3)], {"reps": (2, 1, 3)}, [0]),
    ("repeat", "repeat", [_r(30, 2, 3)], {"repeats": 3, "axis": 1}, [0]),
    ("repeat_flat", "repeat", [_r(31, 2, 3)], {"repeats": 2}, [0]),
    ("reverse", "reverse", [_r(32, 2, 3, 4)], {"axis": (0, 2)}, [0]),
    ("gather_nd", "gather_nd",
     [_r(33, 4, 5, 3), np.array([[0, 3, 1], [4, 0, 2]], np.float32)],
     {}, [0]),
    ("scatter_nd", "scatter_nd",
     [_r(34, 3, 2), np.array([[0, 2, 3], [1, 0, 4]], np.float32)],
     {"shape": (4, 5, 2)}, [0]),
    ("batch_take", "batch_take", [_r(35, 4, 6), _idx(36, 6, 4)], {}, [0]),
    ("slice_like", "slice_like", [_r(37, 4, 5, 6), _r(38, 2, 3, 9)],
     {"axes": (0, 1)}, [0]),
    ("slice_like_all", "slice_like", [_r(39, 4, 5), _r(40, 3, 2)], {},
     [0]),
    ("broadcast_axis", "broadcast_axis", [_r(41, 2, 1, 3)],
     {"axis": (1,), "size": (4,)}, [0]),
    ("broadcast_like", "broadcast_like", [_r(42, 1, 3), _r(43, 4, 3)], {},
     [0]),
    ("depth_to_space", "depth_to_space", [_r(44, 2, 8, 3, 4)],
     {"block_size": 2}, [0]),
    ("space_to_depth", "space_to_depth", [_r(45, 2, 3, 4, 6)],
     {"block_size": 2}, [0]),
    ("diag_matrix", "diag", [_r(46, 4, 5)], {"k": 1}, [0]),
    ("diag_vector", "diag", [_r(47, 4)], {"k": -1}, [0]),
    ("eye", "_eye", [], {"N": 4, "M": 6, "k": 1}, []),
    ("gemm", "_linalg_gemm", [_r(48, 2, 3, 4), _r(49, 2, 5, 4),
                              _r(50, 2, 3, 5)],
     {"transpose_b": True, "alpha": 0.5, "beta": 2.0}, [0, 1, 2]),
    ("gemm2", "_linalg_gemm2", [_r(51, 4, 3), _r(52, 4, 5)],
     {"transpose_a": True, "alpha": 1.5}, [0, 1]),
    ("potrf", "_linalg_potrf", [_spd(53, 4)], {}, [0]),
    ("potri", "_linalg_potri", [_lower(54, 4)], {}, [0]),
    ("trsm", "_linalg_trsm", [_lower(55, 4), _r(56, 4, 3)],
     {"alpha": 0.5}, [0, 1]),
    ("trsm_transpose", "_linalg_trsm", [_lower(57, 4), _r(58, 4, 3)],
     {"transpose": True}, [0, 1]),
    ("trsm_rightside", "_linalg_trsm", [_lower(59, 4), _r(60, 3, 4)],
     {"rightside": True}, [0, 1]),
    ("trmm", "_linalg_trmm", [_lower(61, 4), _r(62, 4, 3)],
     {"transpose": True, "alpha": 2.0}, [0, 1]),
    ("trmm_rightside", "_linalg_trmm", [_lower(63, 4), _r(64, 3, 4)],
     {"rightside": True}, [0, 1]),
    ("sumlogdiag", "_linalg_sumlogdiag", [np.abs(_lower(65, 4))], {}, [0]),
    ("syrk", "_linalg_syrk", [_r(66, 3, 5)], {"alpha": 0.5}, [0]),
    ("syrk_transpose", "_linalg_syrk", [_r(67, 3, 5)],
     {"transpose": True}, [0]),
    ("shape_array", "shape_array", [_r(68, 2, 3, 4)], {}, []),
    ("size_array", "size_array", [_r(69, 2, 3, 4)], {}, []),
    # ops/extra.py
    ("softmax_cross_entropy", "softmax_cross_entropy",
     [_r(70, 5, 4), _idx(71, 4, 5)], {}, [0]),
    ("gelqf", "_linalg_gelqf", [_r(72, 3, 5)], {}, [0]),
    # forward only (rows aligned by sign); the eigenvalues' gradient has
    # a test of its own
    ("syevd", "_linalg_syevd", [_spd(73, 4)], {}, []),
    ("slice_assign", "_slice_assign", [_r(74, 4, 5), _r(75, 2, 2)],
     {"begin": (1, 0), "end": (3, 4), "step": (1, 2)}, [0, 1]),
    ("slice_assign_scalar", "_slice_assign_scalar", [_r(76, 4, 5)],
     {"begin": (0, 1), "end": (2, 3), "scalar": 2.5}, [0]),
    # slice with negative steps: None bounds, explicit bounds (negative
    # ones too), a step past the axis, and an empty selection
    ("slice_neg_step_none", "slice",
     [np.arange(12, dtype=np.float32).reshape(3, 4)],
     {"begin": (None, None), "end": (None, None), "step": (-1, 2)}, [0]),
    ("slice_neg_step_bounds", "slice", [_r(120, 5, 6, 4)],
     {"begin": (4, 1, None), "end": (0, 5, None), "step": (-2, 3, -1)},
     [0]),
    ("slice_neg_step_negative_bounds", "slice", [_r(121, 7, 5)],
     {"begin": (-2, None), "end": (-7, 1), "step": (-3, -1)}, [0]),
    ("slice_neg_step_long", "slice", [_r(122, 4, 3)],
     {"begin": (3, 0), "end": (None, 3), "step": (-5, 1)}, [0]),
    ("slice_neg_step_empty", "slice", [_r(123, 4, 3)],
     {"begin": (1, 0), "end": (3, 3), "step": (-1, 1)}, [0]),
    ("scatter_set_nd", "_scatter_set_nd",
     [_r(77, 4, 5), _r(78, 3), np.array([[0, 2, 3], [1, 4, 0]],
                                        np.float32)],
     {}, [0, 1]),
    ("kl_sparse_reg", "IdentityAttachKLSparseReg",
     [_r(79, 6, 4, lo=0.05, hi=0.95), _r(80, 4, lo=0.05, hi=0.95)],
     {"penalty": 0.01, "sparseness_target": 0.2, "momentum": 0.8}, [0]),
    ("cross_device_copy", "_CrossDeviceCopy", [_r(81, 3, 4)], {}, [0]),
    ("identity_like_rhs", "_identity_with_attr_like_rhs",
     [_r(82, 3, 4), _r(83, 2)], {}, [0]),
    # ops/tensor.py: shape, reduction and elementwise families
    ("SwapAxis", "SwapAxis", [_r(84, 2, 3, 4)], {"dim1": 0, "dim2": 2},
     [0]),
    ("reshape_like", "reshape_like", [_r(85, 2, 6), _r(86, 3, 4)], {}, [0]),
    ("argmax_channel", "argmax_channel", [_r(87, 4, 5)], {}, []),
    ("nansum", "nansum", [_NANS], {"axis": 1}, [0]),
    ("nanprod", "nanprod", [_r(88, 3, 4, lo=0.5, hi=1.5)], {"axis": 0},
     [0]),
    ("square_sum", "_square_sum", [_r(89, 3, 5)],
     {"axis": 1, "keepdims": True}, [0]),
    ("grad_add", "_grad_add", [_r(90, 3, 4), _r(91, 3, 4)], {}, [0, 1]),
    ("elemwise_mul", "elemwise_mul", [_r(92, 3, 4), _r(93, 3, 4)], {},
     [0, 1]),
    ("elemwise_div", "elemwise_div",
     [_r(94, 3, 4), _r(95, 3, 4, lo=0.5, hi=2.0)], {}, [0, 1]),
] + [
    # the scalar ops
    (name, name, [_r(100 + i, 3, 5, lo=lo, hi=hi)], {"scalar": sc},
     [0] if grad else [])
    for i, (name, sc, lo, hi, grad) in enumerate((
        ("_plus_scalar", 1.5, -1, 1, True),
        ("_minus_scalar", 0.5, -1, 1, True),
        ("_mul_scalar", -2.0, -1, 1, True),
        ("_div_scalar", 4.0, -1, 1, True),
        ("_mod_scalar", 0.7, 0.05, 0.65, True),
        ("_rmod_scalar", 2.5, 0.9, 1.2, True),
        ("_rpower_scalar", 1.7, -1, 1, True),
        ("_hypot_scalar", 0.5, -1, 1, True),
        ("_maximum_scalar", 0.1, -1, 1, True),
        ("_minimum_scalar", 0.1, -1, 1, True),
        ("_equal_scalar", 0.0, -1, 1, False),
        ("_not_equal_scalar", 0.0, -1, 1, False),
        ("_greater_scalar", 0.2, -1, 1, False),
        ("_greater_equal_scalar", 0.2, -1, 1, False),
        ("_lesser_scalar", 0.2, -1, 1, False),
        ("_logical_and_scalar", 1.0, -1, 1, False),
        ("_logical_or_scalar", 0.0, -1, 1, False),
        ("_logical_xor_scalar", 1.0, -1, 1, False)))
] + [
    # the broadcast ops: (3, 4) against (1, 4)
    (name, name, [_r(130 + i, 3, 4, lo=lo, hi=hi),
                  _r(150 + i, 1, 4, lo=lo2, hi=hi2)], {},
     [0, 1] if grad else [])
    for i, (name, lo, hi, lo2, hi2, grad) in enumerate((
        ("broadcast_greater_equal", -1, 1, -1, 1, False),
        ("broadcast_lesser", -1, 1, -1, 1, False),
        ("broadcast_lesser_equal", -1, 1, -1, 1, False),
        ("broadcast_not_equal", -1, 1, -1, 1, False),
        ("broadcast_minimum", -1, 1, -1, 1, True),
        ("broadcast_mod", 0.1, 3.0, 0.7, 1.3, True),
        ("broadcast_power", 0.5, 2.0, -1, 1, True),
        ("broadcast_hypot", -1, 1, -1, 1, True),
        ("broadcast_logical_and", -1, 1, -1, 1, False),
        ("broadcast_logical_or", -1, 1, -1, 1, False),
        ("broadcast_logical_xor", -1, 1, -1, 1, False)))
] + [
    # the unary ops, each on its domain
    (name, name, [_r(170 + i, 3, 5, lo=lo, hi=hi)], {}, [0])
    for i, (name, lo, hi) in enumerate((
        ("sin", -3, 3), ("cos", -3, 3), ("tan", -1.2, 1.2),
        ("arcsin", -0.9, 0.9), ("arccos", -0.9, 0.9), ("arctan", -3, 3),
        ("sinh", -2, 2), ("cosh", -2, 2), ("arcsinh", -3, 3),
        ("arccosh", 1.1, 4), ("arctanh", -0.9, 0.9), ("degrees", -3, 3),
        ("radians", -200, 200), ("erf", -2, 2), ("erfinv", -0.9, 0.9),
        ("gammaln", 0.2, 5), ("expm1", -2, 2), ("log10", 0.1, 10),
        ("log1p", -0.5, 3), ("cbrt", 0.1, 8), ("rcbrt", 0.1, 8),
        ("rsqrt", 0.1, 4), ("reciprocal", 0.5, 3), ("fix", -3.3, 3.3),
        ("rint", -3.3, 3.3), ("trunc", -3.3, 3.3),
        ("logical_not", -1, 1)))
] + [
    # gradients at kinks and ties: the JAX package's (0.5 of the
    # cotangent at a tie of max/min, relu and clip; abs +1 at 0 and -0.0)
    ("relu_tie", "relu", [_KINKS], {}, [0]),
    ("_relu_tie", "_relu", [_KINKS], {}, [0]),
    ("Activation_relu_tie", "Activation", [_KINKS], {"act_type": "relu"},
     [0]),
    ("abs_tie", "abs", [_KINKS], {}, [0]),
    ("clip_tie", "clip", [_KINKS], {"a_min": -1.0, "a_max": 2.0}, [0]),
    ("maximum_scalar_tie", "_maximum_scalar", [_KINKS], {"scalar": 0.5},
     [0]),
    ("minimum_scalar_tie", "_minimum_scalar", [_KINKS], {"scalar": 0.5},
     [0]),
] + [
    # the contrib ops of ROADMAP item 17 (the detection family's R-CNN
    # ops, samplers, CTC, fft and the rest), with their traps as cases
    ("ROIPooling", "ROIPooling", [_r(300, 2, 3, 12, 16), _rois(301, 6, 2)],
     {"pooled_size": (3, 3), "spatial_scale": 0.5}, [0]),
    # after ReLU zeros tie in whole plateaus; integer data ties often
    ("ROIPooling_relu_plateaus", "ROIPooling",
     [np.maximum(_r(302, 2, 3, 12, 16), 0.6), _rois(303, 8, 2)],
     {"pooled_size": (4, 3), "spatial_scale": 0.5}, [0]),
    ("ROIPooling_integer_ties", "ROIPooling",
     [_idx(304, 3, 1, 2, 10, 11), _rois(305, 8, 1, 20, 22)],
     {"pooled_size": (3, 4), "spatial_scale": 0.5}, [0]),
    ("PSROIPooling", "_contrib_PSROIPooling",
     [_r(306, 1, 8, 10, 12), _rois(307, 5, 1, 20, 24)],
     {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 2,
      "group_size": 2}, [0]),
    ("DeformableConvolution", "_contrib_DeformableConvolution",
     [_r(308, 1, 4, 7, 8), _r(309, 1, 36, 7, 8, lo=-1.5, hi=1.5),
      _r(310, 6, 2, 3, 3), _r(311, 6)],
     {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6, "num_group": 2,
      "num_deformable_group": 2}, [0, 1, 2, 3]),
    # integer offsets sit on the floor's kinks, half-integer ones put
    # samples exactly on the -0.5 / w - 0.5 border and on clip's bounds
    ("DeformableConvolution_kinks", "_contrib_DeformableConvolution",
     [_r(312, 1, 2, 6, 7), np.random.RandomState(313).choice(
         [-1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0], (1, 18, 6, 7))
      .astype(np.float32), _r(314, 3, 2, 3, 3)],
     {"kernel": (3, 3), "pad": (1, 1), "num_filter": 3, "no_bias": True},
     [0, 1, 2]),
    ("DeformablePSROIPooling", "_contrib_DeformablePSROIPooling",
     [_r(315, 1, 16, 10, 12), _rois(316, 4, 1, 20, 24),
      _r(317, 4, 4, 2, 2)],
     {"spatial_scale": 0.5, "output_dim": 4, "group_size": 2,
      "pooled_size": 2, "part_size": 2, "sample_per_part": 2,
      "trans_std": 0.1}, [0, 2]),
    ("DeformablePSROIPooling_no_trans", "_contrib_DeformablePSROIPooling",
     [_r(318, 1, 8, 10, 12), _rois(319, 4, 1, 20, 24)],
     {"spatial_scale": 0.5, "output_dim": 2, "group_size": 2,
      "pooled_size": 2, "sample_per_part": 3, "no_trans": True}, [0]),
    ("BilinearSampler", "BilinearSampler",
     [_r(320, 2, 3, 6, 7), _r(321, 2, 2, 4, 5, lo=-1.1, hi=1.1)], {},
     [0, 1]),
    ("GridGenerator_affine", "GridGenerator", [_r(322, 2, 6)],
     {"transform_type": "affine", "target_shape": (4, 5)}, [0]),
    ("GridGenerator_warp", "GridGenerator", [_r(323, 2, 2, 5, 6)],
     {"transform_type": "warp"}, [0]),
    ("SpatialTransformer", "SpatialTransformer",
     [_r(324, 2, 3, 6, 7), (np.array([1, 0, 0, 0, 1, 0], np.float32)
                            + 0.2 * _r(325, 2, 6))],
     {"target_shape": (4, 5)}, [0, 1]),
    ("AdaptiveAvgPooling2D", "_contrib_AdaptiveAvgPooling2D",
     [_r(326, 2, 3, 7, 9)], {"output_size": (3, 4)}, [0]),
    ("BilinearResize2D", "_contrib_BilinearResize2D", [_r(327, 2, 3, 5, 6)],
     {"height": 8, "width": 4}, [0]),
    ("Correlation", "Correlation", [_r(328, 1, 3, 9, 10), _r(329, 1, 3, 9,
                                                               10)],
     {"kernel_size": 3, "max_displacement": 2, "pad_size": 2}, [0, 1]),
    ("Correlation_abs_stride2", "Correlation",
     [_r(330, 2, 2, 11, 12), _r(331, 2, 2, 11, 12)],
     {"kernel_size": 1, "max_displacement": 4, "stride1": 2, "stride2": 2,
      "pad_size": 4, "is_multiply": False}, [0, 1]),
    ("Crop", "Crop", [_r(332, 2, 3, 7, 8)],
     {"h_w": (3, 4), "offset": (1, 2)}, [0]),
    ("Crop_center_like", "Crop", [_r(333, 2, 3, 7, 8), _r(334, 2, 3, 4, 5)],
     {"num_args": 2, "center_crop": True}, [0]),
    ("CTCLoss", "CTCLoss", [_r(335, 6, 3, 5, lo=-2, hi=2), np.array(
        [[1, 2, 0], [3, 3, 1], [2, 0, 0]], np.float32)], {}, [0]),
    ("CTCLoss_lengths_last", "ctc_loss",
     [_r(336, 7, 3, 5, lo=-2, hi=2), np.array(
         [[1, 2, -1], [0, 0, 3], [2, -1, -1]], np.float32),
      np.array([7, 5, 6], np.float32), np.array([2, 3, 1], np.float32)],
     {"use_data_lengths": True, "use_label_lengths": True,
      "blank_label": "last"}, [0]),
    # no alignment fits 3 labels with a repeat into 3 frames: a finite
    # loss near 1e30, not inf
    ("CTCLoss_infeasible", "CTCLoss", [_r(337, 3, 2, 4, lo=-2, hi=2),
                                       np.array([[1, 1, 2], [2, 3, 0]],
                                                np.float32)], {}, [0]),
    ("fft", "_contrib_fft", [_r(338, 2, 3, 8)], {}, [0]),
    ("ifft", "_contrib_ifft", [_r(339, 2, 16)], {}, [0]),
    ("count_sketch", "_contrib_count_sketch",
     [_r(340, 3, 6), _idx(341, 4, 1, 6),
      np.sign(_r(342, 1, 6)).astype(np.float32)], {"out_dim": 4}, [0]),
    ("khatri_rao", "khatri_rao", [_r(343, 3, 4), _r(344, 2, 4)],
     {"num_args": 2}, [0, 1]),
    ("quadratic", "_contrib_quadratic", [_r(345, 3, 4)],
     {"a": 1.5, "b": -2.0, "c": 0.5}, [0]),
    # anchors in the padding and boxes under rpn_min_size score -1.0 and
    # tie: pre_n reaches into them, post_n past the kept boxes cycles
    ("Proposal", "_contrib_Proposal",
     [_rpn_probs(346, 1, 9, 4, 6), _r(347, 1, 36, 4, 6, lo=-0.3, hi=0.3),
      np.array([[60, 90, 1.0]], np.float32)],
     {"scales": (2.0, 4.0, 8.0), "rpn_pre_nms_top_n": 160,
      "rpn_post_nms_top_n": 100, "threshold": 0.6, "rpn_min_size": 8},
     [0, 1]),
    ("MultiProposal", "_contrib_MultiProposal",
     [_rpn_probs(348, 2, 9, 4, 6), _r(349, 2, 36, 4, 6, lo=-0.3, hi=0.3),
      np.array([[64, 96, 1.0], [50, 70, 0.8]], np.float32)],
     {"scales": (2.0, 4.0, 8.0), "rpn_pre_nms_top_n": 60,
      "rpn_post_nms_top_n": 40, "threshold": 0.5}, [0, 1]),
]


def _cotangents(outs, seed):
    rng = np.random.RandomState(1000 + seed)
    return [rng.standard_normal(np.shape(o)).astype(np.float32)
            for o in outs]


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _jax(name, ins, attrs, diff, seed):
    schema = jreg.get_op(name)
    parsed = schema.parse_attrs(attrs)
    octx = jreg.OpCtx(is_train=True)
    xs = [jnp.asarray(x) for x in ins]

    def f(*d):
        args = list(xs)
        for i, v in zip(diff, d):
            args[i] = v
        return tuple(schema.fcompute(parsed, octx, *args))

    if not diff:
        return [np.asarray(o) for o in f()], []
    outs, vjp = jax.vjp(f, *[xs[i] for i in diff])
    cts = _cotangents(outs, seed)
    cts = tuple(jnp.asarray(c) if _is_float(o) else
                np.zeros(np.shape(o), jax.dtypes.float0)
                for c, o in zip(cts, outs))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in vjp(cts)]


def _torch(name, ins, attrs, diff, seed):
    schema = treg.get_op(name)
    parsed = schema.parse_attrs(attrs)
    octx = treg.OpCtx(is_train=True, device=torch.device("cpu"))
    xs = [torch.tensor(x) for x in ins]
    leaves = [xs[i].requires_grad_(True) for i in diff]
    with torch.enable_grad():
        outs = schema.fcompute(parsed, octx, *xs)
    onp = [o.detach().numpy() for o in outs]
    if not diff:
        return onp, []
    cts = _cotangents(onp, seed)
    pairs = [(o, torch.tensor(c)) for o, c in zip(outs, cts)
             if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in pairs],
                                leaves, [c for _, c in pairs],
                                allow_unused=True)
    return onp, [np.zeros_like(ins[i]) if g is None else g.numpy()
                 for i, g in zip(diff, grads)]


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not _is_float(want):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL + RTOL * scale, err_msg=what)


def _align_rows(u, ref):
    """Eigenvector rows of ``u`` flipped to the sign of ``ref``'s: the
    JAX op leaves LAPACK's signs, which another LAPACK build may flip."""
    s = np.sign(np.sum(u * ref, axis=-1, keepdims=True))
    return u * np.where(s == 0, 1, s)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_against_jax(case):
    cid, name, ins, attrs, diff = case
    seed = CASES.index(case)
    jo, jg = _jax(name, ins, attrs, diff, seed)
    to, tg = _torch(name, ins, attrs, diff, seed)
    assert len(to) == len(jo), (len(to), len(jo))
    if name == "_linalg_syevd":
        to[0] = _align_rows(to[0], jo[0])
        np.testing.assert_allclose(to[0].T @ np.diag(to[1]) @ to[0], ins[0],
                                   rtol=1e-5, atol=1e-4)
    for k, (a, b) in enumerate(zip(to, jo)):
        if np.asarray(b).dtype != np.asarray(a).dtype and not (
                _is_float(a) and _is_float(b)):
            # shape_array / size_array: the reference's int64 in the port,
            # int32 in the JAX package without x64
            a, b = np.asarray(a).astype(np.int64), np.asarray(b) \
                .astype(np.int64)
        _close(a, b, "%s output %d" % (cid, k))
    for k, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, "%s gradient of input %d" % (cid, diff[k]))


def test_syevd_eigenvalue_gradient_against_jax():
    """The eigenvalues' gradient (independent of the vectors' signs)."""
    a = _spd(90, 5)
    ct = np.random.RandomState(91).standard_normal(5).astype(np.float32)
    schema = jreg.get_op("_linalg_syevd")
    parsed = schema.parse_attrs({})
    g_j = jax.grad(lambda x: jnp.sum(schema.fcompute(
        parsed, jreg.OpCtx(), x)[1] * ct))(jnp.asarray(a))
    x = torch.tensor(a, requires_grad=True)
    ts = treg.get_op("_linalg_syevd")
    w = ts.fcompute(ts.parse_attrs({}), treg.OpCtx(), x)[1]
    (g_t,) = torch.autograd.grad((w * torch.tensor(ct)).sum(), x)
    _close(g_t.numpy(), np.asarray(g_j), "syevd eigenvalue gradient")


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_the_port_lacks_exactly_the_named_ops():
    """None: the port's registry holds every op of the JAX package's, and
    every registered name of the JAX package (aliases too) resolves to
    the same op."""
    jax_ops, port_ops = set(jreg.list_ops()), set(treg.list_ops())
    assert port_ops == jax_ops
    for name, schema in jreg._REGISTRY.items():
        assert treg.get_op(name).name == schema.name, name


@pytest.mark.parametrize("name,op", [
    ("ROIPooling", "ROIPooling"), ("_contrib_Proposal", "_contrib_Proposal"),
    ("ctc_loss", "CTCLoss"), ("Custom", "Custom"),
    ("Correlation", "Correlation"), ("_contrib_fft", "_contrib_fft"),
    ("khatri_rao", "khatri_rao")])
def test_a_formerly_unported_op_resolves(name, op):
    """get_op, and the mx.nd / mx.sym namespaces, resolve the op to the
    JAX schema's name; an unknown op still raises."""
    import mxnet_tpu_torch as tmx
    assert treg.get_op(name).name == jreg.get_op(name).name == op
    for ns in (tmx.nd, tmx.sym):
        assert callable(getattr(ns, name))
    with pytest.raises(MXNetError, match="not registered$"):
        treg.get_op("no_such_op")
