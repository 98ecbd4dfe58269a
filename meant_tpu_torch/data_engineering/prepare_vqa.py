"""VQA-v2 preparation (counterpart of
meant_tpu/data_engineering/prepare_vqa.py; the reference's
`prepare_vqa.py:9-60` and `vqa_manual.py`).

Annotations + questions JSON -> records {ques_id, img_path, question,
MC_ans, answers-with-counts}, then the soft-score targets + fixed-shape npz
the vqa CLI consumes (data.vqa does the scoring/collation)."""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List

import numpy as np

from meant_tpu_torch.data.vqa import (build_label2id, soft_targets,
                                      vqa_collate)


def extract_records(questions_json: str, annotations_json: str,
                    image_root: str, split: str = "train2014") -> List[dict]:
    """`prepare_vqa.py:9-60`: one record per question."""
    with open(questions_json) as f:
        questions = {q["question_id"]: q
                     for q in json.load(f)["questions"]}
    with open(annotations_json) as f:
        annotations = json.load(f)["annotations"]
    records = []
    for ann in annotations:
        q = questions[ann["question_id"]]
        counts = Counter(a["answer"] for a in ann["answers"])
        records.append({
            "ques_id": ann["question_id"],
            "img_path": os.path.join(
                image_root,
                f"COCO_{split}_{ann['image_id']:012d}.jpg"),
            "question": q["question"],
            "MC_ans": ann.get("multiple_choice_answer"),
            "answers": dict(counts),
        })
    return records


def prepare(records: List[dict], tokenize, out_npz: str, max_text_len: int,
            height: int, width: int, label2id: Dict[str, int] = None,
            drop_bad: bool = True):
    """Tokenize questions, load+center-pad images, build soft targets, save
    the npz the vqa CLI reads. `drop_bad` runs the reference's clean-bad
    filter first (`vqa.py:372-400`: rows with empty soft labels removed)."""
    from meant_tpu_torch.data_engineering.image_prep import load_chart
    if drop_bad:
        from meant_tpu_torch.data.datasets import clean_bad_vqa, filter_arrays
        bad, good = clean_bad_vqa(records)
        if bad:
            print(f"Rows removed: {len(bad)}")
            print(f"Indices remaining: {len(good)}")
        records = filter_arrays(records, good)
    if label2id is None:
        label2id = build_label2id([list(r["answers"]) for r in records])
    rows = []
    for r in records:
        rows.append({
            "input_ids": tokenize(r["question"]),
            "image": load_chart(r["img_path"], max(height, width)),
            "soft_target": soft_targets(r["answers"], label2id),
        })
    batch = vqa_collate(rows, len(label2id), max_text_len, height, width)
    np.savez(out_npz, input_ids=batch["language_input_ids"],
             attention_mask=batch["attention_mask"],
             images=batch["pixel_values"], pixel_mask=batch["pixel_mask"],
             soft_targets=batch["labels"])
    return label2id
