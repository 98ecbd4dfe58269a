"""Which parameters' gradients of a flagship training step do not repeat
bit for bit on the card.

    python3 meant_tpu_torch/tools/step_determinism.py [det]

Run from the repository's root on the card: builds the kernels, then
three times builds the flagship (`chip_smoke.build_flagship`, flash=True,
fixed_proj=True, seed 0, dropout off) and takes one forward and backward
of `meant_trainer`'s objective on the same 16-row batch, and prints, for
runs 2 and 3 against run 1, whether the loss is equal and which
parameters' gradients differ. With `det` it runs under
`torch.use_deterministic_algorithms(True, warn_only=True)` and prints the
warnings that mode raised.
"""

from __future__ import annotations

import os
import sys
import warnings

import torch

RUNS = 3


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from meant_tpu_torch.cuda_build import build_all
    from meant_tpu_torch.train.classify import model_inputs, sigmoid_ce_loss
    build_all(cs.KERNELS)
    det = argv[:1] == ["det"]
    if det:
        torch.use_deterministic_algorithms(True, warn_only=True)
    batch = cs.to_card(cs.train_batch(cs.BATCH, seed=1))
    runs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(RUNS):
            model = cs.build_flagship(flash=True, fixed_proj=True)
            for m in model.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.p = 0.0
            args, kwargs = model_inputs("meant_src", batch)
            loss = sigmoid_ce_loss(model(*args, **kwargs), batch["y"])
            loss.backward()
            torch.cuda.synchronize()
            runs.append((loss.item(), {n: p.grad for n, p in
                                       model.named_parameters()}))
            del model
    print(f"{'deterministic' if det else 'default'} algorithms on "
          f"{cs.card_line()}")
    for msg in sorted({str(w.message)[:160] for w in caught}):
        print("warning:", msg)
    for i in range(1, RUNS):
        differ = [n for n, g in runs[0][1].items()
                  if not torch.equal(g, runs[i][1][n])]
        print(f"run {i + 1} vs run 1: loss equal {runs[i][0] == runs[0][0]};"
              f" {len(differ)} gradients differ: {differ}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
