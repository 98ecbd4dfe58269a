"""The loss of bench.py's ner cell over its first ner_trainer steps, at
several learning rates, dropout rates and clip norms, on one card.

    python -m meant_tpu_torch.tools.ner_first_steps [--steps 8]

bench.py's `ner` geometry (TokenClassifier 768 wide, 12 layers of 12
heads, vocab 64001, 9 tags, s=256, batch 32, bf16, the batch chip_smoke.py
draws as bench.py does), one replayed batch: for each setting, the loss
in eval mode (no dropout) before and after the steps and each step's
training loss. Adam's first update is lr times the sign of each gradient
entry, whatever the clip, so at 134M parameters a large lr overshoots
before the loss falls.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from meant_tpu_torch.cuda_build import build_all
    from meant_tpu_torch.data.loader import ArrayLoader
    from meant_tpu_torch.train.ner import TokenClassifier, ner_trainer

    print(cs.card_line(), flush=True)
    build_all(("adamw",))
    host = cs.ner_batch()
    batch = cs.to_card(host)
    for dropout in (0.1, 0.0):
        for lr, clip in ((5e-5, None), (1e-5, None), (3e-6, None),
                         (1e-6, None), (5e-5, 1.0), (1e-5, 1.0)):
            model = TokenClassifier(
                num_labels=cs.NER_TAGS, vocab_size=64001, hidden_size=cs.DIM,
                num_layers=cs.ENCODERS, num_heads=12, dropout=dropout,
                dtype=torch.bfloat16, device="cuda", seed=0)
            trainer = ner_trainer({
                "model": model,
                "train_data": ArrayLoader(host, cs.NER_BATCH), "lr": lr,
                "lrst": "constant", "clip_norm": clip})
            with torch.no_grad():
                model.eval()
                before = trainer.loss(batch).item()
            losses = [trainer.train_step(batch).item()
                      for _ in range(args.steps)]
            with torch.no_grad():
                model.eval()
                after = trainer.loss(batch).item()
            print(f"dropout {dropout} lr {lr} clip {clip}: eval {before:.4f}"
                  f" -> {after:.4f}; train "
                  f"{[round(x, 4) for x in losses]}", flush=True)
            del model, trainer
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
