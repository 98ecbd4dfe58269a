"""VQA data utilities (counterpart of meant_tpu/data/vqa.py; numpy only,
the port's own copy).

  * soft-score labels: score = min(1, count / 3) per annotator answer, and
    the global label2id over the answers of every split;
  * the collator: text padded to a fixed length with `pad_id` and its
    attention mask; images centre-padded to a fixed (height, width) with a
    pixel mask.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def get_score(count: int) -> float:
    """VQA-v2 soft score (`vqa_manual.py` `get_score = min(1, count/3)`)."""
    return min(1.0, count / 3.0)


def build_label2id(answer_lists: Sequence[Sequence[str]]) -> Dict[str, int]:
    """Global answer vocabulary over all splits (`vqa.py:401-408`)."""
    label2id: Dict[str, int] = {}
    for answers in answer_lists:
        for ans in answers:
            if ans not in label2id:
                label2id[ans] = len(label2id)
    return label2id


def soft_targets(answers_with_counts: Dict[str, int],
                 label2id: Dict[str, int]) -> np.ndarray:
    """Per-question soft target vector from answer counts."""
    target = np.zeros((len(label2id),), np.float32)
    for ans, count in answers_with_counts.items():
        if ans in label2id:
            target[label2id[ans]] = get_score(count)
    return target


def pad_text(ids_list: List[np.ndarray], max_len: int, pad_id: int = 0):
    """Fixed-shape text padding + attention mask (mask = id != pad
    convention, `src/utils/custom_datasets.py:263`)."""
    n = len(ids_list)
    out = np.full((n, max_len), pad_id, np.int32)
    mask = np.zeros((n, max_len), np.float32)
    for i, ids in enumerate(ids_list):
        L = min(len(ids), max_len)
        out[i, :L] = ids[:L]
        mask[i, :L] = 1.0
    return out, mask


def center_pad_images(images: List[np.ndarray], height: int, width: int):
    """Center-pad (c, h, w) images to (c, height, width) + pixel mask
    (`utils/custom_datasets.py:144-160` semantics, fixed output shape)."""
    n = len(images)
    c = images[0].shape[0]
    out = np.zeros((n, c, height, width), np.float32)
    pixel_mask = np.zeros((n, height, width), np.float32)
    for i, img in enumerate(images):
        _, h, w = img.shape
        h = min(h, height)
        w = min(w, width)
        top = (height - h) // 2
        left = (width - w) // 2
        out[i, :, top:top + h, left:left + w] = img[:, :h, :w]
        pixel_mask[i, top:top + h, left:left + w] = 1.0
    return out, pixel_mask


def vqa_collate(records: List[dict], num_classes: int, max_text_len: int,
                height: int, width: int, pad_id: int = 1):
    """records: dicts with input_ids (list[int]), image (c,h,w) float array,
    soft_target (num_classes,). Returns the fixed-shape batch the
    vqa_trainer consumes."""
    ids, mask = pad_text([np.asarray(r["input_ids"]) for r in records],
                         max_text_len, pad_id)
    imgs, pixel_mask = center_pad_images([r["image"] for r in records],
                                         height, width)
    labels = np.stack([r["soft_target"] for r in records])
    return {"language_input_ids": ids, "attention_mask": mask,
            "pixel_values": imgs, "pixel_mask": pixel_mask,
            "labels": labels.astype(np.float32)}
