"""BERT: a bidirectional encoder with the MLM and NSP pretraining heads
(``paddle_tpu/models/bert.py``).

A Paddle ``Layer`` model over the port's ``nn.TransformerEncoder``: its
parameters are facade Parameters under the JAX model's names and
layouts (``models.load_reference_state_dict`` takes the JAX model's
``state_dict`` as it is). The masked-LM head is tied to the token
embedding (its logits are ``h @ word_embeddings.weight.T``, no weight of
its own); the NSP head reads the pooled ``[CLS]``. An ``attention_mask``
``[B, S]`` of 1/0 becomes the bool ``[B, 1, 1, S]`` key-padding mask, the
form that sends attention to flash attention (the CUDA kernels K1-K3 on
the card) rather than the dense path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import nn
from ..autograd.engine import apply_op
from ..nn import functional as F
from ..ops._apply import ensure_tensor
from ..tensor import Tensor

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "bert_tiny", "bert_base"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size
        if self.hidden_size % self.num_heads:
            raise ValueError("num_heads must divide hidden_size")


def bert_tiny(**kw) -> BertConfig:
    cfg = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
               max_position_embeddings=128, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0)
    cfg.update(kw)
    return BertConfig(**cfg)


def bert_base(**kw) -> BertConfig:
    return BertConfig(**kw)


def _normal(std):
    return nn.ParamAttr(initializer=nn.initializer.Normal(mean=0.0, std=std))


class BertEmbeddings(nn.Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        std = config.initializer_range
        self.word_embeddings = nn.Embedding(
            config.vocab_size, config.hidden_size, weight_attr=_normal(std))
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size,
            weight_attr=_normal(std))
        self.token_type_embeddings = nn.Embedding(
            config.type_vocab_size, config.hidden_size,
            weight_attr=_normal(std))
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       epsilon=config.layer_norm_epsilon)
        self.drop_p = config.hidden_dropout_prob

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        ids = ensure_tensor(input_ids)
        B, S = ids.shape
        dev = ids._value.device
        if position_ids is None:
            position_ids = Tensor._wrap(torch.arange(
                S, dtype=torch.int32, device=dev)[None, :].expand(B, S))
        if token_type_ids is None:
            token_type_ids = Tensor._wrap(torch.zeros(
                (B, S), dtype=torch.int32, device=dev))
        x = (self.word_embeddings(ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        x = self.layer_norm(x)
        if self.drop_p and self.training:
            x = F.dropout(x, self.drop_p)
        return x


class BertModel(nn.Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        layer = nn.TransformerEncoderLayer(
            config.hidden_size, config.num_heads, config.intermediate_size,
            dropout=config.hidden_dropout_prob,
            attn_dropout=config.attention_dropout_prob,
            act_dropout=0.0, activation="gelu", normalize_before=False)
        self.encoder = nn.TransformerEncoder(layer, config.num_layers)
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size,
                                weight_attr=_normal(config.initializer_range))

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        if attention_mask is not None:
            # [B, S] 1/0 mask → BOOL [B, 1, 1, S] (True = attend): the
            # form scaled_dot_product_attention consumes natively and
            # the one that routes padded batches onto the flash kernel
            # (additive -1e4 bias would fall back to naive [S,S] math)
            am = ensure_tensor(attention_mask)
            attention_mask = apply_op(
                lambda m: m[:, None, None, :].float() > 0.5, [am],
                differentiable=False, name="bert_attn_mask")
        sequence_output = self.encoder(x, src_mask=attention_mask)
        pooled = F.tanh(self.pooler(sequence_output[:, 0]))
        return sequence_output, pooled


class BertForPretraining(nn.Layer):
    """MLM (tied decoder) + NSP heads, summed loss (original recipe)."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.bert = BertModel(config)
        std = config.initializer_range
        self.transform = nn.Linear(config.hidden_size, config.hidden_size,
                                   weight_attr=_normal(std))
        self.transform_norm = nn.LayerNorm(config.hidden_size,
                                           epsilon=config.layer_norm_epsilon)
        self.nsp_head = nn.Linear(config.hidden_size, 2,
                                  weight_attr=_normal(std))

    def mlm_logits(self, sequence_output):
        h = self.transform_norm(F.gelu(self.transform(sequence_output)))
        w = self.bert.embeddings.word_embeddings.weight
        return apply_op(lambda hh, ww: hh @ ww.T,
                        [ensure_tensor(h), ensure_tensor(w)],
                        name="tied_mlm_head")

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_labels=None):
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask)
        mlm = self.mlm_logits(seq)
        nsp = self.nsp_head(pooled)
        if masked_lm_labels is None:
            return mlm, nsp
        # label -100 marks unmasked positions (ignored); the range names
        # its kernels for tools/profile_train.py
        with torch.profiler.record_function("mlm_cross_entropy"):
            mlm_loss = F.cross_entropy(
                mlm.reshape((-1, self.config.vocab_size)),
                ensure_tensor(masked_lm_labels).reshape((-1,)),
                ignore_index=-100)
        loss = mlm_loss
        if next_sentence_labels is not None:
            loss = loss + F.cross_entropy(
                nsp, ensure_tensor(next_sentence_labels).reshape((-1,)))
        return (mlm, nsp), loss


class BertForSequenceClassification(nn.Layer):
    def __init__(self, config: BertConfig, num_classes: int = 2):
        super().__init__()
        self.bert = BertModel(config)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)
        self.classifier = nn.Linear(config.hidden_size, num_classes,
                                    weight_attr=_normal(
                                        config.initializer_range))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return logits, F.cross_entropy(logits,
                                       ensure_tensor(labels).reshape((-1,)))
