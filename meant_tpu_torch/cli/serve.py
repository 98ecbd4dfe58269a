"""Batch-inference CLI around meant_tpu_torch.serve.Predictor (counterpart
of meant_tpu/cli/serve.py).

    python -m meant_tpu_torch.cli.serve -rid 0 [-mn meant] \\
        [--seq_len 128] --serve_batch 16 [--input batch.npz] [--output p.npy]

`--input` is an .npz whose arrays match the model's batch keys (tweets /
graphs / attention_masks, and prices for meantPrice, for the paper
generation; input_ids / pixels / prices / attention_mask for meant_src);
without it a synthetic smoke batch of that shape is served. Weights are
those of `--checkpoint` (written by the port's trainer,
`cli/in_loop_train.py`), else a seeded random init (`--seed`); `--int8`
and `--export` are not ported yet and raise.
"""

from __future__ import annotations

import numpy as np

from meant_tpu_torch.cli.common import (base_parser, build_model,
                                        synthetic_batch)
from meant_tpu_torch.serve import Predictor


def serve_parser():
    p = base_parser()
    p.add_argument("--checkpoint", type=str, default=None,
                   help="params of a checkpoint of the port's trainer")
    p.add_argument("--input", type=str, default=None,
                   help=".npz of batch arrays; synthetic smoke if omitted")
    p.add_argument("--output", type=str, default=None,
                   help="write probabilities to this .npy")
    p.add_argument("--serve_batch", type=int, default=32)
    p.add_argument("--int8", action="store_true",
                   help="not ported yet: raises if set")
    p.add_argument("--export", type=str, default=None,
                   help="not ported yet: raises if given")
    return p


def main(argv=None):
    args = serve_parser().parse_args(argv)
    for flag, value in (("--int8", args.int8), ("--export", args.export)):
        if value:
            raise NotImplementedError(
                f"{flag} is not ported to meant_tpu_torch yet (see ROADMAP)")
    model = build_model(args)
    if args.input:
        with np.load(args.input) as z:
            batch = {k: z[k] for k in z.files}
    else:
        print("No --input: synthetic smoke batch.")
        batch = synthetic_batch(args, args.synthetic_n)
        del batch["y"]
    predictor = Predictor(model, args.model_name,
                          checkpoint_path=args.checkpoint,
                          batch_size=args.serve_batch,
                          device=next(model.parameters()).device)
    probs = predictor(batch)
    print(f"served {len(probs)} rows -> probs shape {probs.shape}, "
          f"mean {float(probs.mean()):.4f}")
    if args.output:
        np.save(args.output, probs)
        print(f"wrote {args.output}")
    return probs


if __name__ == "__main__":
    main()
