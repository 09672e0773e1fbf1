"""Correctness helpers of the port (the counterpart of mxnet.test_utils).

bfloat16 / float16 attention is held element by element: ``half_units``
measures ``|got - ref|`` in units of (one ulp of ``|ref|`` there + one ulp
of the root-sum-square of the terms that element sums), ulps of got's
type. The second ulp is the scale at which rounding a factor of those
terms moves the sum: the kernels round P and dS to the input type before
their second product, as the TPU kernels do, while the plain versions
round once at the end, and a row's terms can cancel to a sum far below
them (the first causal rows of dQ). A tensor-wide scale would not do:
causal rows and keys differ in magnitude by 30x and more.
``attention_term_scales`` gives those root-sum-squares, and
``attention_without_keys`` the control that such a check must reject: the
same attention with one tile of keys left out of every row.

``jpeg_fixture`` reads the committed JPEG fixture (tests/data/
jpeg_fixture.npz): JPEG records beside the JAX package's decode of each,
for the card's decoders, which are held against it without JAX.
"""
import numpy as np
import torch

__all__ = ["half_ulp", "half_units", "attention_term_scales",
           "decode_term_scales", "attention_without_keys", "jpeg_fixture"]


def half_ulp(x, dtype):
    """One ulp of |x| in ``dtype`` (bfloat16 / float16), subnormals
    included."""
    fi = torch.finfo(dtype)
    return torch.exp2(torch.floor(torch.log2(
        x.float().abs().clamp_min(fi.tiny)))) * fi.eps


def half_units(got, ref, terms):
    """Largest ``|got - ref|`` in units of ulp(|ref|) + ulp(terms), in
    got's type; ``terms`` is the root-sum-square of the terms each element
    sums (``attention_term_scales``)."""
    r = ref.float()
    unit = half_ulp(r, got.dtype) + half_ulp(terms, got.dtype)
    return float(((got.float() - r).abs() / unit).max())


def _scores(q, k, causal, scale, drop=None):
    """f32 masked scores (B, H, S_q, S_k) of attention, GQA keys repeated,
    and the scale; ``drop`` (start, stop) leaves those keys out of every
    row."""
    d, s_q, s_k = q.shape[-1], q.shape[2], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kr = k.float().repeat_interleave(q.shape[1] // k.shape[1], 1)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    keep = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device)
    if causal:
        keep = keep.tril(s_k - s_q)
    if drop is not None:
        keep[:, drop[0]:drop[1]] = False
    return sc.masked_fill(~keep, float("-inf")), scale


def attention_term_scales(q, k, v, causal=False, scale=None, o=None,
                          do=None, glse=None):
    """Root-sum-squares of the terms of each output element, in f32:
    ``(out,)`` or, given ``o`` and ``do``, ``(out, dq, dk, dv)``.

    out sums p v; dV sums p dO; dQ and dK sum dS k and dS q scaled, with
    dS = p (dP - delta) taken at its magnitude before the subtraction,
    p (|dP| + sum |dO o| + |glse|): rounding o or delta moves dS by a
    fraction of that, however far the two cancel."""
    g = q.shape[1] // k.shape[1]
    sc, scale = _scores(q, k, causal, scale)
    p = torch.softmax(sc, -1)
    del sc
    p2 = p.square()
    vr = v.float().repeat_interleave(g, 1)
    r_out = torch.einsum("bhqk,bhkd->bhqd", p2, vr.square()).sqrt()
    if do is None:
        return (r_out,)
    dof = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr).abs()
    mag = (dof * o.float()).abs().sum(-1)
    if glse is not None:
        mag = mag + glse.float().abs()
    a2 = (p * (dp + mag[..., None]) * scale).square()
    del dp
    kr = k.float().repeat_interleave(g, 1)
    r_dq = torch.einsum("bhqk,bhkd->bhqd", a2, kr.square()).sqrt()
    dk2 = torch.einsum("bhqk,bhqd->bhkd", a2, q.float().square())
    dv2 = torch.einsum("bhqk,bhqd->bhkd", p2, dof.square())
    b, h, s, d = dk2.shape
    dk2 = dk2.reshape(b, h // g, g, s, d).sum(2)
    dv2 = dv2.reshape(b, h // g, g, s, d).sum(2)
    return r_out, r_dq, dk2.sqrt(), dv2.sqrt()


def decode_term_scales(q, k, v, lengths, scale=None):
    """Root-sum-squares of the terms (p v) of each decode output element:
    q (B, H, D), k/v (B, H_kv, S, D), the first ``lengths[b]`` keys
    valid; 0 for a slot with no key."""
    d, s = q.shape[-1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    g = q.shape[1] // k.shape[1]
    kr = k.float().repeat_interleave(g, 1)
    vr = v.float().repeat_interleave(g, 1)
    sc = torch.einsum("bhd,bhsd->bhs", q.float(), kr) * scale
    n = torch.as_tensor(lengths, device=q.device).to(torch.int64)
    valid = torch.arange(s, device=q.device)[None, None, :] \
        < n.reshape(-1, 1, 1)
    p = torch.softmax(sc.masked_fill(~valid, float("-inf")), -1)
    p = torch.nan_to_num(p)
    return torch.einsum("bhs,bhsd->bhd", p.square(), vr.square()).sqrt()


def attention_without_keys(q, k, v, start, stop, causal=False, scale=None,
                           do=None, glse=None):
    """The control of a check: self-attention with keys ``start`` ..
    ``stop`` left out of every row, as a kernel that skipped one K/V tile
    would give, in f32 and rounded to the inputs' type: ``(out,)`` or,
    given ``do``, ``(out, dq, dk, dv)`` by autograd (dk and dv of the
    left-out keys are 0)."""
    with torch.set_grad_enabled(do is not None):
        qf, kf, vf = (t.detach().float().requires_grad_(do is not None)
                      for t in (q, k, v))
        sc, _ = _scores(qf, kf, causal, scale, (start, stop))
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(sc, -1),
                           vf.repeat_interleave(q.shape[1] // k.shape[1], 1))
        if do is None:
            return (out.detach().to(q.dtype),)
        loss = (out * do.float()).sum()
        if glse is not None:
            loss = loss + (torch.logsumexp(sc, -1) * glse.float()).sum()
        grads = torch.autograd.grad(loss, (qf, kf, vf))
    return tuple(t.detach().to(q.dtype) for t in (out, *grads))


def jpeg_fixture(path):
    """[(record bytes, decoded BGR pixels)] of a fixture written by
    tests/test_torch_image.py's ``write_fixture``."""
    f = np.load(path)
    ends = [int(e) for e in f["record_ends"]]
    recs = [f["records"][a:b].tobytes() for a, b in zip([0] + ends, ends)]
    offs = np.concatenate([[0], np.cumsum([int(np.prod(s))
                                           for s in f["shapes"]])])
    return [(r, f["pixels"][offs[i]:offs[i + 1]].reshape(f["shapes"][i]))
            for i, r in enumerate(recs)]

