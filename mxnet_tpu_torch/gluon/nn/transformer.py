"""Transformer blocks (counterpart of mxnet_tpu/gluon/nn/transformer.py):
the same equations, parameter names and registered ops. The attention
core is ``F._contrib_flash_attention``: eagerly (``mx.nd``) and
hybridized (the executor) alike it reaches the port's trainable
``ops.attention.flash_attention`` — the flash forward kernel, and the dQ
and dK/dV kernels in its backward, on the card; their plain versions on
the CPU."""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Dense, Dropout, LayerNorm, Embedding

__all__ = ["MultiHeadAttention", "TransformerEncoderCell",
           "TransformerEncoder"]


class MultiHeadAttention(HybridBlock):
    """Multi-head scaled-dot-product attention over (batch, seq, units),
    with one Dense each for the query, key, value and output
    projections."""

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

    def _split_heads(self, F, x):
        # (B, S, U) -> (B, H, S, U/H)
        x = F.reshape(x, shape=(0, 0, self._num_heads, -1))
        return F.transpose(x, axes=(0, 2, 1, 3))

    def hybrid_forward(self, F, query, key=None, value=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(F, self.proj_query(query))
        k = self._split_heads(F, self.proj_key(key))
        v = self._split_heads(F, self.proj_value(value))
        att = F._contrib_flash_attention(q, k, v, causal=self._causal)
        att = F.transpose(att, axes=(0, 2, 1, 3))
        att = F.reshape(att, shape=(0, 0, -1))
        out = self.proj_out(att)
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
    (batch, seq, units) features (add a Dense head for LM/classification)."""

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
        shape = getattr(tokens, "shape", None)   # Symbols have no shape
        if isinstance(shape, tuple) and len(shape) > 1 and \
                isinstance(shape[1], int) and shape[1] > self._max_length:
            raise ValueError(
                f"sequence length {shape[1]} exceeds max_length "
                f"{self._max_length} (positional table size)")
        x = self.embed(tokens)
        # positions 0..S-1 of each row, from a cumulative sum of ones
        # (traceable in both namespaces)
        ones = F.ones_like(tokens)
        pos = F.cumsum(ones, axis=1) - 1
        x = x + self.pos_embed(pos)
        for cell in self.cells:
            x = cell(x)
        return self.ln_final(x)
