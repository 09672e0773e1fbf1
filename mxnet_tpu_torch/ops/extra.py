"""Long-tail operators (counterpart of mxnet_tpu/ops/extra.py):
``softmax_cross_entropy``, the LQ and symmetric eigen factorizations,
the mutation ops behind ``__setitem__`` (``_slice_assign``,
``_slice_assign_scalar``, ``_scatter_set_nd``),
``IdentityAttachKLSparseReg``, the placement identities
``_CrossDeviceCopy`` and ``_identity_with_attr_like_rhs``, the ops of
the dense-backed sparse storage (``cast_storage``, ``_sparse_retain``,
``_sparse_adagrad_update``), the image ops ``_image_to_tensor`` and
``_image_normalize`` (``mx.nd.image``), and the reference's legacy
names of registered ops.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

from .registry import Param, register, register_alias

__all__ = []


def _softmax_cross_entropy(attrs, octx, data, label):
    logp = torch.log_softmax(data, dim=-1)
    picked = torch.gather(logp, 1, label.to(torch.int64)[:, None])[:, 0]
    return (-torch.sum(picked),)


register("softmax_cross_entropy", _softmax_cross_entropy,
         inputs=("data", "label"),
         infer_shape=lambda attrs, s: ([s[0], (s[0][0],) if s[0] else s[1]],
                                       [(1,)]))


# ---------------------------------------------------------------------------
# linalg: gelqf (LQ factorization), syevd (symmetric eigendecomposition)
# ---------------------------------------------------------------------------

def _linalg_gelqf(attrs, octx, a):
    """A = L Q with Q's rows orthonormal, from the QR of A^T, signs set
    so that diag(L) >= 0 (LAPACK gelqf's convention)."""
    qt, rt = torch.linalg.qr(a.transpose(-1, -2))
    q, l = qt.transpose(-1, -2), rt.transpose(-1, -2)
    d = torch.sign(torch.diagonal(l, dim1=-2, dim2=-1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    return (l * d[..., None, :], q * d[..., :, None])


def _gelqf_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None, None]
    return in_shapes, [tuple(s[:-1]) + (s[-2],), tuple(s)]


register("_linalg_gelqf", _linalg_gelqf, inputs=("A",), num_outputs=2,
         infer_shape=_gelqf_infer, aliases=("linalg_gelqf",))


def _linalg_syevd(attrs, octx, a):
    """(U, w): the rows of U the eigenvectors, w ascending. Each
    eigenvector's sign is LAPACK's, as jnp.linalg.eigh leaves it."""
    w, u = torch.linalg.eigh(a)
    return (u.transpose(-1, -2), w)


def _syevd_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None, None]
    return in_shapes, [tuple(s), tuple(s[:-1])]


register("_linalg_syevd", _linalg_syevd, inputs=("A",), num_outputs=2,
         infer_shape=_syevd_infer, aliases=("linalg_syevd",))


# ---------------------------------------------------------------------------
# mutation ops backing __setitem__: a new tensor with the slice set
# ---------------------------------------------------------------------------

def _slice_params():
    return {"begin": Param("shape", None, True),
            "end": Param("shape", None, True),
            "step": Param("shape", None)}


def _norm_slices(attrs):
    begin, end = attrs["begin"], attrs["end"]
    step = attrs["step"] or (1,) * len(begin)
    out = []
    for i, (b, e) in enumerate(zip(begin, end)):
        s = step[i] if i < len(step) else 1
        out.append(slice(b, e, s if s != 0 else None))
    return tuple(out)


def _slice_assign(attrs, octx, lhs, rhs):
    out = lhs.clone()
    out[_norm_slices(attrs)] = rhs
    return (out,)


def _slice_assign_scalar(attrs, octx, data):
    out = data.clone()
    out[_norm_slices(attrs)] = attrs["scalar"]
    return (out,)


def _scatter_set_nd(attrs, octx, lhs, rhs, indices):
    idx = indices.to(torch.int64)
    return (lhs.index_put(tuple(idx[i] for i in range(idx.shape[0])), rhs),)


register("_slice_assign", _slice_assign, params=_slice_params(),
         inputs=("lhs", "rhs"), infer_shape=lambda attrs, s: (s, [s[0]]))
register("_slice_assign_scalar", _slice_assign_scalar,
         params={**_slice_params(), "scalar": Param("float", 0.0)},
         inputs=("data",), infer_shape=lambda attrs, s: (s, [s[0]]))
register("_scatter_set_nd", _scatter_set_nd,
         params={"shape": Param("shape", None)},
         inputs=("lhs", "rhs", "indices"),
         infer_shape=lambda attrs, s: (s, [s[0]]))


# ---------------------------------------------------------------------------
# IdentityAttachKLSparseReg: identity forward; the backward adds the
# KL-sparseness penalty's gradient at the momentum-smoothed mean
# activation kept in the ``moving_avg`` aux state
# ---------------------------------------------------------------------------

class _KLSparseReg(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, avg, penalty, sparseness):
        ctx.save_for_backward(avg)
        ctx.penalty, ctx.sparseness = penalty, sparseness
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        (avg,) = ctx.saved_tensors
        a = avg.clamp(1e-6, 1 - 1e-6)
        s = ctx.sparseness
        kl = ctx.penalty * (-s / a + (1 - s) / (1 - a))
        return g + kl[None, :], None, None, None


def _identity_kl_sparse_reg(attrs, octx, data, moving_avg):
    m = attrs["momentum"]
    if octx.is_train:
        new_avg = m * moving_avg + (1 - m) * torch.mean(data.detach(), dim=0)
    else:
        new_avg = moving_avg
    new_avg = new_avg.detach()
    return (_KLSparseReg.apply(data, new_avg, attrs["penalty"],
                               attrs["sparseness_target"]), new_avg)


def _kl_reg_infer(attrs, in_shapes):
    ds = in_shapes[0]
    in_shapes = list(in_shapes)
    if ds is not None and in_shapes[1] is None:
        in_shapes[1] = (ds[-1],)
    return in_shapes, [ds]


register("IdentityAttachKLSparseReg", _identity_kl_sparse_reg,
         params={"sparseness_target": Param("float", 0.1),
                 "penalty": Param("float", 0.001),
                 "momentum": Param("float", 0.9)},
         inputs=("data", "moving_avg"), aux=("moving_avg",),
         mutates_aux=True, infer_shape=_kl_reg_infer)


# ---------------------------------------------------------------------------
# placement identities: the executor places values, so inside one walk
# these pass their (left) input through
# ---------------------------------------------------------------------------

register("_CrossDeviceCopy", lambda attrs, octx, data: (data.view_as(data),),
         inputs=("data",), infer_shape=lambda attrs, s: (s, [s[0]]))
register("_identity_with_attr_like_rhs",
         lambda attrs, octx, lhs, rhs: (lhs.view_as(lhs),),
         inputs=("lhs", "rhs"), infer_shape=lambda attrs, s: (s, [s[0]]))


# ---------------------------------------------------------------------------
# the reference's legacy and backend-specific names of registered ops
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# sparse storage, dense-backed (ndarray/sparse.py): a storage cast is the
# identity on the tensor; the stype lives on the NDArray wrapper
# ---------------------------------------------------------------------------

register("cast_storage", lambda attrs, octx, data: (data.clone(),),
         params={"stype": Param("str", None, True)})


def _sparse_retain(attrs, octx, data, indices):
    keep = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    keep[indices.to(torch.int64)] = True
    return (torch.where(keep.reshape((-1,) + (1,) * (data.ndim - 1)), data,
                        torch.zeros((), dtype=data.dtype,
                                    device=data.device)),)


register("_sparse_retain", _sparse_retain, inputs=("data", "indices"),
         infer_shape=lambda attrs, s: (s, [s[0]]))


@torch.no_grad()
def _sparse_adagrad_update(attrs, octx, weight, grad, history):
    # the rowwise AdaGrad update run densely (optimizer_op.cc
    # _sparse_adagrad_update): every row, the same values where the
    # gradient is dense
    if attrs["wd"] != 0.0:
        # the reference refuses it too (optimizer_op-inl.h:1747)
        raise MXNetError("_sparse_adagrad_update does not support wd != 0")
    g = grad * attrs["rescale_grad"]
    c = attrs["clip_gradient"]
    if c is not None and c > 0:
        g = g.clamp(-c, c)
    new_hist = history + torch.square(g)
    return (weight - attrs["lr"] * g / (torch.sqrt(new_hist)
                                        + attrs["epsilon"]), new_hist)


register("_sparse_adagrad_update", _sparse_adagrad_update,
         params={"lr": Param("float", None, True),
                 "epsilon": Param("float", 1e-7),
                 "wd": Param("float", 0.0),
                 "rescale_grad": Param("float", 1.0),
                 "clip_gradient": Param("float", -1.0)},
         inputs=("weight", "grad", "history"), aux=("history",),
         mutates_aux=True, aux_always=True)


# ---------------------------------------------------------------------------
# image ops (src/operator/image/image_random.cc): to_tensor, normalize
# ---------------------------------------------------------------------------

def _image_to_tensor(attrs, octx, data):
    """HWC (or NHWC) [0, 255] -> CHW (NCHW) float32 [0, 1]."""
    x = data.to(torch.float32) / 255.0
    if data.dim() == 3:
        return (x.permute(2, 0, 1),)
    return (x.permute(0, 3, 1, 2),)


def _to_tensor_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None]
    if len(s) == 3:
        return in_shapes, [(s[2], s[0], s[1])]
    return in_shapes, [(s[0], s[3], s[1], s[2])]


register("_image_to_tensor", _image_to_tensor, inputs=("data",),
         infer_shape=_to_tensor_infer, aliases=("image_to_tensor",))


def _image_normalize(attrs, octx, data):
    """(x - mean[c]) / std[c] over the channel axis of CHW / NCHW."""
    mean = torch.as_tensor(attrs["mean"], dtype=data.dtype,
                           device=data.device)
    std = torch.as_tensor(attrs["std"], dtype=data.dtype, device=data.device)
    shape = (-1, 1, 1) if data.dim() == 3 else (1, -1, 1, 1)
    return ((data - mean.reshape(shape)) / std.reshape(shape),)


register("_image_normalize", _image_normalize,
         params={"mean": Param("floats", (0.0,)),
                 "std": Param("floats", (1.0,))},
         inputs=("data",), aliases=("image_normalize",))


for _alias, _name in (
        ("Convolution_v1", "Convolution"), ("Pooling_v1", "Pooling"),
        ("BatchNorm_v1", "BatchNorm"), ("CuDNNBatchNorm", "BatchNorm"),
        ("_contrib_SparseEmbedding", "Embedding"),
        ("_add", "elemwise_add"), ("_sub", "elemwise_sub"),
        ("_mod", "broadcast_mod"), ("_Mod", "broadcast_mod"),
        ("_Maximum", "broadcast_maximum"), ("_Minimum", "broadcast_minimum"),
        ("_Hypot", "broadcast_hypot"),
        ("_Greater_Equal", "broadcast_greater_equal"),
        ("_Lesser_Equal", "broadcast_lesser_equal"),
        ("_Logical_And", "broadcast_logical_and"),
        ("_Logical_Or", "broadcast_logical_or"),
        ("_Logical_Xor", "broadcast_logical_xor"),
        ("_LogicalAndScalar", "_logical_and_scalar"),
        ("_LogicalOrScalar", "_logical_or_scalar"),
        ("_LogicalXorScalar", "_logical_xor_scalar"),
        ("_crop_assign", "_slice_assign"),
        ("_crop_assign_scalar", "_slice_assign_scalar"),
        ("_scatter_plus_scalar", "_plus_scalar"),
        ("_scatter_minus_scalar", "_minus_scalar"),
        ("_scatter_elemwise_div", "elemwise_div"),
        ("_sparse_dot", "dot"), ("_sparse_zeros_like", "zeros_like"),
        ("_sparse_cast_storage", "cast_storage")):
    register_alias(_alias, _name)
