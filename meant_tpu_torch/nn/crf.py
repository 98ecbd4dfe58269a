"""Linear-chain conditional random field (counterpart of
meant_tpu/nn/crf.py): `bio_constraint_mask`, `CRF` and
`CRFTokenClassifier`, the tweet7 harness's `--crf --impl_crf` head.

Semantics kept from the JAX module (allennlp's):
  * score(x, y) = start[y_0] + sum_t emis[t, y_t] + sum_t trans[y_t, y_t+1]
    + end[y_T]; the loss is logZ - score, the mean over the batch;
  * the mask is multiplied by `tags != -100`; a masked step adds no
    emission and no transition, so alpha and the gold path carry through
    it and interior masked positions chain their neighbours; the first
    unmasked step opens with start + emission; a fully masked row scores 0;
  * viterbi gives the masked and the opening steps identity backpointers;
    the BIO constraint applies at decode only, as NEG (-1e4), never in the
    loss; argmax takes the first index of a tie, as jnp.argmax does.

JAX's three recursions are `lax.scan`s over time; here each is a Python
loop over the sequence on (b, T, T) tensors, every one in fp32 whatever the
emissions' dtype. No Pallas kernel runs in the JAX module, so none runs
here: a training step issues some 80 small launches a position (the
partition and the gold path, forward and backward).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from meant_tpu_torch.device import resolve_device
from meant_tpu_torch.nn.layers import SeededInit

NEG = -1e4  # allennlp's score of a forbidden transition


def bio_constraint_mask(id2label: Dict[int, str]) -> np.ndarray:
    """(T+2, T+2) bool, [from, to] allowed under BIO; the virtual START is
    index T and END T+1. Anything may go to O or B-X; I-X only follows B-X
    or I-X of the same type; START opens O or B-X; anything closes to
    END."""
    T = len(id2label)
    allowed = np.zeros((T + 2, T + 2), bool)
    start, end = T, T + 1

    def kind(i):
        lab = id2label[i]
        if lab == "O":
            return "O", None
        prefix, _, ent = lab.partition("-")
        return prefix, ent

    for i in range(T):
        ki, ei = kind(i)
        if ki in ("O", "B"):
            allowed[start, i] = True
        allowed[i, end] = True
        for j in range(T):
            kj, ej = kind(j)
            if kj in ("O", "B"):
                allowed[i, j] = True
            elif kj == "I":
                allowed[i, j] = (ki in ("B", "I")) and (ei == ej)
    return allowed


class CRF(SeededInit, nn.Module):
    """Transitions are parameters, drawn N(0, 0.02^2) as the JAX module
    draws them; the emissions come from the token classifier."""

    def __init__(self, num_tags: int, device=None):
        super().__init__()
        self.num_tags = num_tags
        self.transitions = nn.Parameter(torch.empty(
            (num_tags, num_tags), device=device))
        self.start_transitions = nn.Parameter(torch.empty(
            (num_tags,), device=device))
        self.end_transitions = nn.Parameter(torch.empty(
            (num_tags,), device=device))

    def reset_parameters(self, generator):
        for p in (self.transitions, self.start_transitions,
                  self.end_transitions):
            p.normal_(0.0, 0.02, generator=generator)

    def forward(self, emissions, tags, mask=None):
        return self.neg_log_likelihood(emissions, tags, mask)

    # ---- training loss --------------------------------------------------
    def neg_log_likelihood(self, emissions: torch.Tensor, tags: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """emissions (b, s, T); tags (b, s) with -100 where unlabelled;
        mask (b, s) {0, 1}. The mean NLL over the batch."""
        emissions = emissions.to(torch.float32)
        if mask is None:
            mask = torch.ones(tags.shape, device=tags.device)
        mask = mask.to(torch.float32) * (tags != -100)
        tags = torch.where(tags == -100, 0, tags).to(torch.int64)
        log_z = self._partition(emissions, mask)
        gold = self._path_score(emissions, tags, mask)
        return (log_z - gold).mean()

    def _partition(self, emissions, mask):
        b, s, T = emissions.shape
        trans = self.transitions.to(torch.float32)
        start = self.start_transitions.to(torch.float32)
        alpha = emissions.new_zeros((b, T))
        started = emissions.new_zeros((b,))
        for t in range(s):
            emis_t, m_t = emissions[:, t], mask[:, t]
            m = m_t[:, None]
            first = (1.0 - started)[:, None] * m
            cont = started[:, None] * m
            nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1)
            alpha = first * (start[None] + emis_t) \
                + cont * (nxt + emis_t) + (1.0 - m) * alpha
            started = torch.maximum(started, m_t)
        final = alpha + self.end_transitions.to(torch.float32)[None]
        # a fully masked row scores 0 (its gold score is 0 too)
        return torch.where(started > 0, torch.logsumexp(final, dim=1), 0.0)

    def _path_score(self, emissions, tags, mask):
        b, s, _ = emissions.shape
        trans = self.transitions.to(torch.float32)
        start = self.start_transitions.to(torch.float32)
        score = emissions.new_zeros((b,))
        prev = torch.zeros((b,), dtype=torch.int64, device=tags.device)
        started = emissions.new_zeros((b,))
        for t in range(s):
            tag_t, m_t = tags[:, t], mask[:, t]
            e = emissions[:, t].gather(1, tag_t[:, None])[:, 0]
            first = (1.0 - started) * m_t
            cont = started * m_t
            score = score + first * (start[tag_t] + e) \
                + cont * (trans[prev, tag_t] + e)
            prev = torch.where(m_t > 0, tag_t, prev)
            started = torch.maximum(started, m_t)
        end = self.end_transitions.to(torch.float32)
        return score + torch.where(started > 0, end[prev], 0.0)

    # ---- decode ---------------------------------------------------------
    @torch.no_grad()
    def viterbi(self, emissions: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                constraint_mask: Optional[np.ndarray] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The best tag path: (tags (b, s) int64, score (b,)). A masked
        position takes the tag its identity backpointer carries.
        constraint_mask: (T+2, T+2) bool from `bio_constraint_mask`,
        applied here only."""
        emissions = emissions.to(torch.float32)
        b, s, T = emissions.shape
        if mask is None:
            mask = emissions.new_ones((b, s))
        mask = mask.to(torch.float32)
        trans = self.transitions.to(torch.float32)
        start = self.start_transitions.to(torch.float32)
        end = self.end_transitions.to(torch.float32)
        if constraint_mask is not None:
            cm = torch.as_tensor(np.asarray(constraint_mask),
                                 device=emissions.device)
            trans = torch.where(cm[:T, :T], trans, NEG)
            start = torch.where(cm[T, :T], start, NEG)
            end = torch.where(cm[:T, T + 1], end, NEG)
        iota = torch.arange(T, device=emissions.device).expand(b, T)
        alpha = emissions.new_zeros((b, T))
        started = emissions.new_zeros((b,))
        backpointers = []
        for t in range(s):
            emis_t, m_t = emissions[:, t], mask[:, t]
            m = m_t[:, None]
            scores = alpha[:, :, None] + trans[None]      # (b, T_prev, T)
            bp = scores.argmax(dim=1)
            nxt = scores.amax(dim=1) + emis_t
            first = (1.0 - started)[:, None] * m
            cont = started[:, None] * m
            alpha = first * (start[None] + emis_t) + cont * nxt \
                + (1.0 - m) * alpha
            backpointers.append(torch.where(cont > 0, bp, iota))
            started = torch.maximum(started, m_t)
        final = alpha + end[None]
        tag = final.argmax(dim=1)
        best_score = final.amax(dim=1)
        path = [None] * s
        for t in range(s - 1, -1, -1):
            path[t] = tag
            tag = backpointers[t].gather(1, tag[:, None])[:, 0]
        return torch.stack(path, dim=1), best_score


class CRFTokenClassifier(nn.Module):
    """TokenClassifier (named `token_classifier`) + CRF head (`crf`):
    forward(input_ids, attention_mask, tags) -> (logits, nll), without tags
    the logits; `decode` runs viterbi (constrained with
    `bio_constraint_mask(id2label)`). `device` is the card unless named;
    the weights are drawn from `seed`."""

    def __init__(self, num_labels: int, vocab_size: int = 64001,
                 hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0):
        super().__init__()
        from meant_tpu_torch.nn.roberta import seeded
        from meant_tpu_torch.train.ner import TokenClassifier
        device = resolve_device(device)
        self.token_classifier = TokenClassifier(
            num_labels, vocab_size, hidden_size, num_layers, num_heads,
            dropout, dtype=dtype, device=device, seed=None)
        self.crf = CRF(num_labels, device=device)
        seeded(self, device, seed)

    def forward(self, input_ids, attention_mask=None, tags=None):
        logits = self.token_classifier(input_ids, attention_mask)
        if tags is None:
            return logits
        return logits, self.crf.neg_log_likelihood(logits, tags,
                                                   attention_mask)

    @torch.no_grad()
    def decode(self, input_ids, attention_mask=None, constraint_mask=None):
        was_training = self.training
        self.eval()
        try:
            logits = self.token_classifier(input_ids, attention_mask)
        finally:
            self.train(was_training)
        return self.crf.viterbi(logits, attention_mask,
                                constraint_mask=constraint_mask)
