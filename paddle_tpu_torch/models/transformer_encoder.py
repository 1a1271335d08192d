"""Transformer encoder as a fluid-layer builder — the port of
``paddle_tpu/models/transformer_encoder.py``, the static-program
counterpart of ``models/ernie.py`` (the reference drives its largest NLP
configs through this surface: tests/unittests/dist_transformer.py and the
ERNIE stack), written over the port's ``layers``.

Attention is the fused ``multihead_matmul`` op (QKV projection, scaled
dot-product softmax and context in one op; on the card the flash
kernels, their bias forms under a padding bias), post-LN blocks and a
ReLU FFN. AMP decorates it as any fluid program.
"""
from __future__ import annotations

import math
from typing import Optional

from .. import layers
from ..framework.param_attr import ParamAttr

__all__ = ["encoder_layer", "encoder", "transformer_encoder_classifier"]


def _mha(x, num_heads, d_model, name, attn_bias=None):
    helper_name = name + "_mha"
    w = layers.create_parameter([d_model, 3 * d_model], "float32",
                                name=helper_name + "_qkv_w")
    b = layers.create_parameter([3 * d_model], "float32",
                                name=helper_name + "_qkv_b")
    from ..framework.layer_helper import LayerHelper

    helper = LayerHelper("multihead_matmul", name=helper_name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = {"Input": [x], "W": [w], "Bias": [b]}
    if attn_bias is not None:
        ins["BiasQK"] = [attn_bias]
    helper.append_op(
        type="multihead_matmul", inputs=ins, outputs={"Out": [out]},
        attrs={"head_number": int(num_heads),
               "alpha": 1.0 / math.sqrt(d_model // num_heads)})
    return layers.fc(out, d_model, num_flatten_dims=2,
                     name=helper_name + "_out")


def encoder_layer(x, num_heads, d_model, d_ff, name, attn_bias=None,
                  dropout=0.0, postprocess="da"):  # da = dropout+add(+ln)
    """One post-LN encoder block (dist_transformer's encoder_layer)."""
    attn = _mha(x, num_heads, d_model, name, attn_bias)
    if dropout:
        attn = layers.dropout(attn, dropout_prob=dropout)
    x = layers.layer_norm(x + attn, begin_norm_axis=2,
                          name=name + "_ln1")
    ff = layers.fc(x, d_ff, num_flatten_dims=2, act="relu",
                   name=name + "_fc1")
    ff = layers.fc(ff, d_model, num_flatten_dims=2, name=name + "_fc2")
    if dropout:
        ff = layers.dropout(ff, dropout_prob=dropout)
    return layers.layer_norm(x + ff, begin_norm_axis=2,
                             name=name + "_ln2")


def encoder(src_ids, pos_ids, vocab_size, max_pos, num_layers, num_heads,
            d_model, d_ff, name="enc", attn_bias=None, dropout=0.0,
            sent_ids=None, sent_vocab=2):
    """Token (+position, +optional sentence) embeddings -> N blocks."""
    emb = layers.embedding(src_ids, size=[vocab_size, d_model],
                           param_attr=ParamAttr(name=name + "_word_emb"))
    pos = layers.embedding(pos_ids, size=[max_pos, d_model],
                           param_attr=ParamAttr(name=name + "_pos_emb"))
    x = emb + pos
    if sent_ids is not None:
        x = x + layers.embedding(
            sent_ids, size=[sent_vocab, d_model],
            param_attr=ParamAttr(name=name + "_sent_emb"))
    x = layers.layer_norm(x, begin_norm_axis=2, name=name + "_emb_ln")
    for i in range(num_layers):
        x = encoder_layer(x, num_heads, d_model, d_ff, f"{name}_l{i}",
                          attn_bias=attn_bias, dropout=dropout)
    return x


def transformer_encoder_classifier(src_ids, pos_ids, label, vocab_size,
                                   max_pos, num_layers=2, num_heads=4,
                                   d_model=64, d_ff=256, num_classes=2,
                                   name="enc", attn_bias=None, dropout=0.0):
    """CLS-token classifier head over the encoder (ERNIE-style fine-tune
    program shape); returns (loss, logits). ``attn_bias`` (an additive
    logit mask, e.g. a [B, 1, 1, S] padding bias) and ``dropout`` pass to
    :func:`encoder`; their defaults build the reference's program."""
    x = encoder(src_ids, pos_ids, vocab_size, max_pos, num_layers,
                num_heads, d_model, d_ff, name=name, attn_bias=attn_bias,
                dropout=dropout)
    cls = layers.slice(x, axes=[1], starts=[0], ends=[1])
    cls = layers.reshape(cls, [-1, d_model])
    pooled = layers.fc(cls, d_model, act="tanh", name=name + "_pool")
    logits = layers.fc(pooled, num_classes, name=name + "_cls")
    loss = layers.reduce_mean(
        layers.softmax_with_cross_entropy(logits, label))
    return loss, logits
