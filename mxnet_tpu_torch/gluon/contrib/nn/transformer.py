"""Transformer building blocks on the flash-attention kernel.

Counterpart of ``mxnet_tpu/gluon/contrib/nn/transformer.py``: the same
blocks, parameters and structural names.  Layers are batch-major
(batch, seq, units).  Self-attention runs through the (B, T, H, D)
flash-attention kernels (``ops/attention.py:self_attention_bshd``: the
hand-written kernels on the card), which read q, k and v in place as the
column blocks of the fused qkv projection's (B, L, 3E) output and write
o as (B, L, E), so no head transpose is made either way; padding masks
(``valid_length``) apply inside them.  The JAX package's layer keeps the
(B, H, T, D) entry, which the TPU ran faster; both compute the same
function.  Only an arbitrary additive ``mask`` takes the composed dense
path.  Attention dropout applies to the attention output, as in the JAX
package.
"""
from __future__ import annotations

from .... import autograd
from ....ndarray.ndarray import _wrap
from ....ops.attention import self_attention_bshd
from ...block import HybridBlock
from ...nn import Dense, Dropout, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderCell", "TransformerEncoder"]


class MultiHeadAttention(HybridBlock):
    """Self-attention with a fused qkv projection: softmax(q·kᵀ/√d
    [+ mask])·v over ``num_heads`` heads."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 use_bias=True, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError("units %d not divisible by num_heads %d"
                             % (units, num_heads))
        self._units = units
        self._heads = num_heads
        self._causal = causal
        with self.name_scope():
            self.qkv = Dense(3 * units, flatten=False, use_bias=use_bias,
                             prefix="qkv_")
            self.proj = Dense(units, flatten=False, use_bias=use_bias,
                              prefix="out_")
            self.drop = Dropout(dropout) if dropout else None

    def _heads_split(self, x):
        # (B, L, H*D) -> (B, H, L, D)
        b, l = x.shape[0], x.shape[1]
        d = self._units // self._heads
        return x.reshape(b, l, self._heads, d).transpose(axes=(0, 2, 1, 3))

    def hybrid_forward(self, F, x, mask=None, valid_length=None):
        b, l = x.shape[0], x.shape[1]
        qkv = self.qkv(x)                          # (B, L, 3E)
        if mask is None:
            lens = None if valid_length is None else valid_length._data
            out = _wrap(autograd.call_op(self_attention_bshd, qkv._data,
                                         self._heads, self._causal, lens))
        else:
            q, k, v = (self._heads_split(part)
                       for part in F.split(qkv, num_outputs=3, axis=-1))
            d = self._units // self._heads
            scores = F.batch_dot(q.reshape(-1, l, d),
                                 k.reshape(-1, l, d),
                                 transpose_b=True) / (d ** 0.5)
            scores = scores.reshape(b, self._heads, l, l) + mask
            if valid_length is not None:
                # keys at or after the row's valid length score -1e30
                col = F.arange(0, l, ctx=x.context).reshape(1, 1, 1, l)
                vl = valid_length.astype("float32").reshape(-1, 1, 1, 1)
                scores = scores + \
                    F.broadcast_greater_equal(col, vl) * -1e30
            probs = F.softmax(scores, axis=-1)
            out = F.batch_dot(probs.reshape(-1, l, l), v.reshape(-1, l, d))
            out = out.reshape(b, self._heads, l, d) \
                .transpose(axes=(0, 2, 1, 3)).reshape(b, l, self._units)
        out = self.proj(out)
        if self.drop is not None:
            out = self.drop(out)
        return out


class PositionwiseFFN(HybridBlock):
    """The transformer MLP: Dense→activation→Dense (+dropout)."""

    def __init__(self, units, hidden_size, activation="gelu", dropout=0.0,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.expand = Dense(hidden_size, flatten=False,
                                activation=activation, prefix="fc1_")
            self.contract = Dense(units, flatten=False, prefix="fc2_")
            self.drop = Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        out = self.contract(self.expand(x))
        if self.drop is not None:
            out = self.drop(out)
        return out


class TransformerEncoderCell(HybridBlock):
    """Post-LN (BERT-style) encoder layer: x → x+MHA(x) → LN → +FFN → LN."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 causal=False, layer_norm_eps=1e-12, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attention = MultiHeadAttention(units, num_heads,
                                                dropout=dropout,
                                                causal=causal,
                                                prefix="attn_")
            self.attn_norm = LayerNorm(epsilon=layer_norm_eps,
                                       prefix="attn_ln_")
            self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout,
                                       prefix="ffn_")
            self.ffn_norm = LayerNorm(epsilon=layer_norm_eps,
                                      prefix="ffn_ln_")

    def hybrid_forward(self, F, x, mask=None, valid_length=None):
        x = self.attn_norm(x + self.attention(x, mask, valid_length))
        return self.ffn_norm(x + self.ffn(x))


class TransformerEncoder(HybridBlock):
    """A stack of ``num_layers`` encoder cells, children ``0``, ``1``, ...
    (structural names ``encoder.0.attention.qkv.weight``...)."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, causal=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            for i in range(num_layers):
                self.register_child(TransformerEncoderCell(
                    units, hidden_size, num_heads, dropout=dropout,
                    causal=causal, prefix="layer%d_" % i))

    def hybrid_forward(self, F, x, mask=None, valid_length=None):
        for cell in self._children.values():
            x = cell(x, mask, valid_length)
        return x
