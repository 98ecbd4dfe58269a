"""Token classification (NER) (counterpart of meant_tpu/train/ner.py):
`ner_ce_loss`, `align_labels`, `join_examples`, `TokenClassifier` and
`ner_trainer`.

Semantics kept from the JAX package (and its reference):
  * the loss is a cross entropy per example (the mean over its labelled
    tokens), then the batch mean; a row with no label counts 0;
    `flat_token_mean=True` takes one mean over every labelled token
    (`mlm_loss`) instead;
  * no gradient clipping unless `clip_norm` is given: A1 launches with no
    norm;
  * `crf=True` drives a `nn.crf.CRFTokenClassifier`: the loss is its NLL,
    and `token_f1` decodes with viterbi under `constraint_mask`;
  * `TokenClassifier` builds its RoBERTa backbone with no pooler and the
    backbone's own defaults: a 130-row position table (ids past it clamp
    to its last row) and layer-norm eps 1e-5, whatever a config says.

`TokenClassifier`'s attention is Flax's plain MHA in both packages, so the
optimizer's kernel A1 is the only hand-written kernel a step launches.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from meant_tpu_torch.data.loader import Prefetcher
from meant_tpu_torch.data.masking import IGNORE_INDEX
from meant_tpu_torch.device import resolve_device
from meant_tpu_torch.nn.layers import Dense
from meant_tpu_torch.nn.roberta import RobertaModel, seeded
from meant_tpu_torch.train.pretrain import _BasePretrainer, mlm_loss
from meant_tpu_torch.utils.metrics import metrics_from_confusion


def ner_ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy per example over its non -100 tokens, then the mean
    over the batch, in fp32; an example with no labelled token gives 0."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).to(torch.int64)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(-1, safe[..., None]).squeeze(-1)
    row_sum = (nll * valid).sum(dim=-1)
    row_cnt = valid.sum(dim=-1)
    row_mean = torch.where(row_cnt > 0,
                           row_sum / torch.clamp(row_cnt, min=1), 0.0)
    return row_mean.mean()


def align_labels(word_ids_batch: Sequence[Sequence[Optional[int]]],
                 word_labels_batch: Sequence[Sequence[int]],
                 ignore_index: int = -100) -> np.ndarray:
    """Word-level tags onto tokens: None (a special token) -> -100; the
    first token of a word -> its tag; a continuation -> -100."""
    out = []
    for word_ids, labels in zip(word_ids_batch, word_labels_batch):
        prev = None
        row = []
        for w in word_ids:
            if w is None or w == prev:
                row.append(ignore_index)
            else:
                row.append(labels[w])
            prev = w
        out.append(row)
    return np.asarray(out, np.int32)


def join_examples(tokens_list, tags_list, join_size: int):
    """Each group of `join_size` consecutive examples concatenated into
    one; a last group shorter than `join_size` is dropped. (The reference
    indexes 0..join_size-1 of the slice it is handed, group-relative;
    JAX's callers hand it per-group slices, which this reproduces.)"""
    out_tokens, out_tags = [], []
    for i in range(0, len(tokens_list) - join_size + 1, join_size):
        toks, tags = [], []
        for x in range(join_size):
            toks += list(tokens_list[i + x])
            tags += list(tags_list[i + x])
        out_tokens.append(toks)
        out_tags.append(tags)
    return out_tokens, out_tags


class TokenClassifier(nn.Module):
    """RoBERTa backbone (`roberta`, no pooler, intermediate 4 x hidden) ->
    dropout (`drop`) -> Dense (`classifier`): forward(input_ids (b, s),
    attention_mask) -> (b, s, num_labels) logits. `device` is the card
    unless named; `seed` None leaves the weights to an enclosing model."""

    def __init__(self, num_labels: int, vocab_size: int = 64001,
                 hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        self.roberta = RobertaModel(
            vocab_size=vocab_size, hidden_size=hidden_size,
            num_layers=num_layers, num_heads=num_heads,
            intermediate_size=4 * hidden_size, dropout=dropout,
            pooler=False, dtype=dtype, device=device, seed=None)
        self.drop = nn.Dropout(dropout)
        self.classifier = Dense(num_labels, hidden_size, dtype=dtype,
                                device=device)
        seeded(self, device, seed)

    def forward(self, input_ids, attention_mask=None):
        hidden = self.roberta(input_ids, attention_mask, return_pooled=False)
        return self.classifier(self.drop(hidden))


class ner_trainer(_BasePretrainer):
    """Batches: input_ids (b, s), attention_mask (b, s), labels (b, s) with
    -100 on unlabelled positions. Adds `crf`, `constraint_mask` and
    `flat_token_mean` to the pretrainer's keys; `clip_norm` defaults to
    None. The loop, early stop and checkpoint are the pretrainer base's."""

    kind = "ner"

    def __init__(self, p):
        self.crf = p.get("crf", False)
        self.constraint_mask = p.get("constraint_mask")
        self.flat_token_mean = p.get("flat_token_mean", False)
        p = dict(p)
        p.setdefault("clip_norm", None)
        super().__init__(p)

    def _apply(self, batch):
        args = [batch["input_ids"], batch["attention_mask"]]
        if self.crf:
            args.append(batch["labels"])     # -> (logits, nll)
        return self.model(*args)

    def _loss(self, out, batch):
        if self.crf:
            return out[1]
        if self.flat_token_mean:
            return mlm_loss(out, batch["labels"])
        return ner_ce_loss(out, batch["labels"])

    @torch.no_grad()
    def token_f1(self, loader, num_labels: int) -> dict:
        """Metrics of the confusion matrix over the labelled (non -100)
        tokens of `loader`; a CRF model predicts by (constrained) viterbi,
        any other by the argmax of its logits. The matrix accumulates on
        the device and is fetched once."""
        self.model.eval()
        cm = torch.zeros(num_labels * num_labels, dtype=torch.int64,
                         device=self.device)
        for batch in Prefetcher(loader, self.device):
            ids, mask = batch["input_ids"], batch["attention_mask"]
            if self.crf:
                preds, _ = self.model.decode(
                    ids, mask, constraint_mask=self.constraint_mask)
            else:
                preds = self.model(ids, mask).argmax(dim=-1)
            labels = batch["labels"]
            valid = labels != IGNORE_INDEX
            idx = torch.where(valid, labels * num_labels + preds, 0)
            cm.index_add_(0, idx.reshape(-1),
                          valid.reshape(-1).to(torch.int64))
        return metrics_from_confusion(
            cm.reshape(num_labels, num_labels).cpu().numpy())
