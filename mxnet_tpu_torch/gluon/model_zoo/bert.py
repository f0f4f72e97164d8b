"""BERT encoder models (``BASELINE.json`` config 5, BERT-base).

Counterpart of ``mxnet_tpu/gluon/model_zoo/bert.py``: the same blocks,
parameters and structural names.  ``BERTModel(...)`` returns the sequence
output, then the pooled [CLS] output when ``use_pooler``, then the
masked-LM logits when ``use_decoder`` (decoded only at
``masked_positions`` when they are given).  Attention runs through the
(B, T, H, D) flash-attention kernels, with ``valid_length`` as their
``kv_lens``, and, with ``MXNET_FUSED_LAYERNORM=1``, LayerNorm through its
kernel.
"""
from __future__ import annotations

from ..block import HybridBlock
from ..nn import Dense, Dropout, Embedding, LayerNorm
from ..contrib.nn.transformer import TransformerEncoder

__all__ = ["BERTModel", "bert_base", "bert_small"]


class BERTModel(HybridBlock):
    """Token + position + segment embeddings → transformer encoder →
    (sequence output, CLS pooled output[, MLM logits])."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 type_vocab_size=2, dropout=0.1, use_pooler=True,
                 use_decoder=False, layer_norm_eps=1e-12, **kwargs):
        super().__init__(**kwargs)
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        with self.name_scope():
            self.word_embed = Embedding(vocab_size, units,
                                        prefix="word_embed_")
            self.pos_embed = Embedding(max_length, units, prefix="pos_embed_")
            self.type_embed = Embedding(type_vocab_size, units,
                                        prefix="type_embed_")
            self.embed_norm = LayerNorm(epsilon=layer_norm_eps,
                                        prefix="embed_ln_")
            self.embed_drop = Dropout(dropout) if dropout else None
            self.encoder = TransformerEncoder(
                num_layers, units, hidden_size, num_heads, dropout=dropout,
                prefix="encoder_")
            if use_pooler:
                self.pooler = Dense(units, flatten=False, activation="tanh",
                                    prefix="pooler_")
            if use_decoder:
                # MLM head: transform + LN + vocab projection
                self.decoder_transform = Dense(units, flatten=False,
                                               activation="gelu",
                                               prefix="decoder_fc_")
                self.decoder_norm = LayerNorm(epsilon=layer_norm_eps,
                                              prefix="decoder_ln_")
                self.decoder = Dense(vocab_size, flatten=False,
                                     prefix="decoder_out_")

    def hybrid_forward(self, F, token_ids, token_types=None, mask=None,
                       valid_length=None, masked_positions=None):
        seq_len = token_ids.shape[1]
        positions = F.arange(0, seq_len, ctx=token_ids.context) \
            .reshape(1, seq_len)
        x = self.word_embed(token_ids) + self.pos_embed(positions)
        if token_types is not None:
            x = x + self.type_embed(token_types)
        x = self.embed_norm(x)
        if self.embed_drop is not None:
            x = self.embed_drop(x)
        seq = self.encoder(x, mask, valid_length)
        outs = [seq]
        if self._use_pooler:
            outs.append(self.pooler(F.slice_axis(seq, axis=1, begin=0,
                                                 end=1).reshape(0, -1)))
        if self._use_decoder:
            # decode only the masked positions when given: B*P rows of the
            # vocabulary projection instead of B*S
            dec_in = seq if masked_positions is None else \
                F.gather_positions(seq, masked_positions)
            outs.append(self.decoder(self.decoder_norm(
                self.decoder_transform(dec_in))))
        return outs[0] if len(outs) == 1 else tuple(outs)


def bert_base(**kwargs):
    """BERT-base: 12 layers, 768 units, 12 heads."""
    return BERTModel(units=768, hidden_size=3072, num_layers=12,
                     num_heads=12, **kwargs)


def bert_small(num_layers=4, units=256, hidden_size=1024, **kwargs):
    """4 layers, 256 units, 4 heads (layer count and widths overridable)."""
    return BERTModel(units=units, hidden_size=hidden_size,
                     num_layers=num_layers, num_heads=4, **kwargs)
