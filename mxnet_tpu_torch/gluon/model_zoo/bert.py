"""BERT model family (GluonNLP architecture) for the port.

Counterpart of ``mxnet_tpu/gluon/model_zoo/bert.py``: the same blocks, the
same parameter names and the same outputs.  Attention runs through the
registered op ``multi_head_attention`` (``registry.dispatch``, where AMP
casts q, k and v to its target dtype), which reaches the
hand-written flash kernel for unmasked attention at head dim 64 or 128
(BERT-base and BERT-large) and the plain composition under a
``valid_length`` mask.
"""
from __future__ import annotations

import torch

from ...ops.registry import dispatch
from .. import nn
from ..block import HybridBlock

__all__ = ["BERTModel", "BERTEncoder", "BERTEncoderLayer",
           "MultiHeadAttention", "PositionwiseFFN", "bert_12_768_12",
           "bert_24_1024_16", "get_bert"]


class MultiHeadAttention(HybridBlock):
    """Self-attention with a fused QKV projection."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError("units %d not divisible by num_heads %d"
                             % (units, num_heads))
        self._units = units
        self._num_heads = num_heads
        self.query_key_value = nn.Dense(3 * units, in_units=units,
                                        flatten=False, use_bias=use_bias)
        self.proj = nn.Dense(units, in_units=units, flatten=False,
                             use_bias=use_bias)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, mask=None):
        q, k, v = self.query_key_value(x).chunk(3, dim=-1)
        out = dispatch("multi_head_attention", q, k, v, mask,
                       num_heads=self._num_heads, scaled=True,
                       units=self._units)
        return self.dropout(self.proj(out))


class PositionwiseFFN(HybridBlock):
    """Two dense layers with GELU between them."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 **kwargs):
        super().__init__(**kwargs)
        self.ffn_1 = nn.Dense(hidden_size, in_units=units, flatten=False)
        self.activation = nn.GELU() if activation == "gelu" else \
            nn.Activation(activation)
        self.ffn_2 = nn.Dense(units, in_units=hidden_size, flatten=False)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        return self.dropout(self.ffn_2(self.activation(self.ffn_1(x))))


class BERTEncoderLayer(HybridBlock):
    """Post-LN transformer layer (BERT convention)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        self.attention = MultiHeadAttention(units, num_heads, dropout)
        self.layer_norm_att = nn.LayerNorm(in_channels=units)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout)
        self.layer_norm_ffn = nn.LayerNorm(in_channels=units)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, mask=None):
        x = self.layer_norm_att(x + self.attention(x, mask))
        return self.layer_norm_ffn(x + self.ffn(x))


class BERTEncoder(HybridBlock):
    """Stack of encoder layers."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 max_length=512, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        self._max_length = max_length
        self._units = units
        self.transformer_cells = nn.HybridSequential()
        for _ in range(num_layers):
            self.transformer_cells.add(
                BERTEncoderLayer(units, hidden_size, num_heads, dropout))

    def forward(self, x, mask=None):
        for cell in self.transformer_cells:
            x = cell(x, mask)
        return x


class BERTModel(HybridBlock):
    """BERT with optional pooler, NSP classifier and MLM decoder.

    ``forward(inputs, token_types=None, valid_length=None)`` returns
    ``(sequence_output, pooled_output[, nsp_logits][, mlm_logits])`` as
    GluonNLP does (just ``sequence_output`` without pooler or decoder).
    """

    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, vocab_size=30522, token_type_vocab_size=2,
                 max_length=512, dropout=0.1, use_pooler=True,
                 use_decoder=True, use_classifier=True, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._max_length = max_length
        self.word_embed = nn.Embedding(vocab_size, units)
        self.token_type_embed = nn.Embedding(token_type_vocab_size, units)
        self.position_embed = nn.Embedding(max_length, units)
        self.embed_layer_norm = nn.LayerNorm(in_channels=units)
        self.embed_dropout = nn.Dropout(dropout)
        self.encoder = BERTEncoder(num_layers, units, hidden_size, num_heads,
                                   max_length, dropout)
        self.use_pooler = use_pooler
        self.use_decoder = use_decoder
        self.use_classifier = use_classifier
        if use_pooler:
            self.pooler = nn.Dense(units, in_units=units, activation="tanh",
                                   flatten=False)
        if use_decoder:
            self.decoder_transform = nn.Dense(units, in_units=units,
                                              flatten=False)
            self.decoder_act = nn.GELU()
            self.decoder_norm = nn.LayerNorm(in_channels=units)
            self.decoder_out = nn.Dense(vocab_size, in_units=units,
                                        flatten=False)
        if use_classifier:
            self.classifier = nn.Dense(2, in_units=units, flatten=False)

    @staticmethod
    def _attention_mask(valid_length, seq_len):
        """(N, 1, 1, T) key mask: position < valid_length."""
        if valid_length is None:
            return None
        steps = torch.arange(seq_len, device=valid_length.device)
        return steps.reshape(1, 1, 1, seq_len) < \
            valid_length.reshape(-1, 1, 1, 1)

    def forward(self, inputs, token_types=None, valid_length=None):
        N, T = inputs.shape
        positions = torch.arange(T, device=inputs.device)
        emb = self.word_embed(inputs)
        if token_types is not None:
            emb = emb + self.token_type_embed(token_types)
        emb = emb + self.position_embed(positions).reshape(1, T, self._units)
        emb = self.embed_dropout(self.embed_layer_norm(emb))
        seq_out = self.encoder(emb, self._attention_mask(valid_length, T))
        outputs = [seq_out]
        if self.use_pooler:
            pooled = self.pooler(seq_out[:, 0, :].reshape(N, self._units))
            outputs.append(pooled)
            if self.use_classifier:
                outputs.append(self.classifier(pooled))
        if self.use_decoder:
            h = self.decoder_norm(self.decoder_act(
                self.decoder_transform(seq_out)))
            outputs.append(self.decoder_out(h))
        return outputs[0] if len(outputs) == 1 else tuple(outputs)


def get_bert(num_layers, units, num_heads, **kwargs):
    """``bert_{layers}_{units}_{heads}`` with hidden size 4 * units."""
    return BERTModel(num_layers=num_layers, units=units,
                     hidden_size=4 * units, num_heads=num_heads, **kwargs)


def bert_12_768_12(**kwargs):
    """BERT-base."""
    return get_bert(12, 768, 12, **kwargs)


def bert_24_1024_16(**kwargs):
    """BERT-large."""
    return get_bert(24, 1024, 16, **kwargs)
