"""Transformer blocks (counterpart of mxnet_tpu/gluon/nn/transformer.py):
the same equations and parameter names. The attention core is the port's
trainable flash attention (``ops.attention.flash_attention``, the
``_contrib_flash_attention`` role): the flash forward kernel, and the dQ
and dK/dV kernels in its backward, on the card; their plain versions on
the CPU."""
from __future__ import annotations

import torch

from ...ops.attention import flash_attention
from ..block import HybridBlock
from .basic_layers import Dense, Dropout, Embedding, LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderCell",
           "TransformerEncoder"]


class MultiHeadAttention(HybridBlock):
    """Multi-head scaled-dot-product attention over (batch, seq, units),
    with one Dense each for the query, key, value and output projections.
    """

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 use_bias=True, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads != 0:
            raise ValueError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._causal = causal
        with self.name_scope():
            self.proj_query = Dense(units, use_bias=use_bias, flatten=False,
                                    prefix="query_")
            self.proj_key = Dense(units, use_bias=use_bias, flatten=False,
                                  prefix="key_")
            self.proj_value = Dense(units, use_bias=use_bias, flatten=False,
                                    prefix="value_")
            self.proj_out = Dense(units, use_bias=use_bias, flatten=False,
                                  prefix="out_")
            self.dropout = Dropout(dropout) if dropout else None

    def _split_heads(self, x):
        # (B, S, U) -> (B, H, S, U/H), contiguous for the kernels
        b, s, _ = x.shape
        return x.reshape(b, s, self._num_heads, -1).transpose(1, 2) \
            .contiguous()

    def hybrid_forward(self, F, query, key=None, value=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.proj_query(query))
        k = self._split_heads(self.proj_key(key))
        v = self._split_heads(self.proj_value(value))
        att = flash_attention(q, k, v, causal=self._causal)
        b, _, s, _ = att.shape
        out = self.proj_out(att.transpose(1, 2).reshape(b, s, -1))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class TransformerEncoderCell(HybridBlock):
    """Pre-norm transformer block: LN -> MHA -> residual, LN -> FFN ->
    residual."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 causal=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ln1 = LayerNorm()
            self.attention = MultiHeadAttention(units, num_heads,
                                                dropout=dropout,
                                                causal=causal)
            self.ln2 = LayerNorm()
            self.ffn1 = Dense(hidden_size, activation="relu", flatten=False,
                              prefix="ffn1_")
            self.ffn2 = Dense(units, flatten=False, prefix="ffn2_")
            self.dropout = Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        h = x + self.attention(self.ln1(x))
        f = self.ffn2(self.ffn1(self.ln2(h)))
        if self.dropout is not None:
            f = self.dropout(f)
        return h + f


class TransformerEncoder(HybridBlock):
    """Token embedding + N pre-norm blocks + final LayerNorm; emits
    (batch, seq, units) features (add a Dense head for an LM). The cells
    are registered as children "2", "3", ... (after embed and pos_embed),
    as in the reference, which their saved keys carry."""

    def __init__(self, vocab_size, units, hidden_size, num_heads, num_layers,
                 max_length=512, dropout=0.0, causal=True, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._max_length = max_length
        with self.name_scope():
            self.embed = Embedding(vocab_size, units, prefix="tok_")
            self.pos_embed = Embedding(max_length, units, prefix="pos_")
            self.cells = []
            for i in range(num_layers):
                cell = TransformerEncoderCell(units, hidden_size, num_heads,
                                              dropout=dropout, causal=causal,
                                              prefix=f"layer{i}_")
                self.register_child(cell)
                self.cells.append(cell)
            self.ln_final = LayerNorm()

    def hybrid_forward(self, F, tokens):
        if tokens.ndim > 1 and tokens.shape[1] > self._max_length:
            raise ValueError(
                f"sequence length {tokens.shape[1]} exceeds max_length "
                f"{self._max_length} (positional table size)")
        x = self.embed(tokens)
        pos = torch.arange(tokens.shape[1], device=tokens.device) \
            .expand(tokens.shape)
        x = x + self.pos_embed(pos)
        for cell in self.cells:
            x = cell(x)
        return self.ln_final(x)
