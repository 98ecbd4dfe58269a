"""Batch-inference CLI around meant_tpu_torch.serve.Predictor (counterpart
of meant_tpu/cli/serve.py).

    python -m meant_tpu_torch.cli.serve -rid 0 [-mn meant] \\
        [--seq_len 128] --serve_batch 16 [--input batch.npz] [--output p.npy]

`--input` is an .npz whose arrays match the model's batch keys (tweets /
graphs / attention_masks, and prices for meantPrice, for the paper
generation; input_ids / pixels / prices / attention_mask for meant_src);
without it a synthetic smoke batch of that shape is served. Weights are
those of `--checkpoint` (written by the port's trainer,
`cli/in_loop_train.py`), else a seeded random init (`--seed`). `--int8`
serves every wide Linear through the int8 product (`nn/quant.py`);
`--export PATH` also writes the forward (int8 with `--int8`) as a
`torch.export` program at `--serve_batch` rows, the first chunk padded by
repeating its first row, servable with `serve.load_exported(PATH)(params,
batch)` without the model code.
"""

from __future__ import annotations

import time

import numpy as np

from meant_tpu_torch.cli.common import (base_parser, build_model,
                                        synthetic_batch)
from meant_tpu_torch.serve import Predictor, export_forward, pad_chunk


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
                   help="quantize every Linear of 32 or more features to "
                        "int8 (nn/quant.py)")
    p.add_argument("--export", type=str, default=None,
                   help="also write the forward as a torch.export program "
                        "(serve.load_exported), servable without the model "
                        "code")
    return p


def main(argv=None):
    args = serve_parser().parse_args(argv)
    quantize = "int8" if args.int8 else None
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
                          device=next(model.parameters()).device,
                          quantize=quantize)
    probs = predictor(batch)
    print(f"served {len(probs)} rows -> probs shape {probs.shape}, "
          f"mean {float(probs.mean()):.4f}")
    if args.export:
        # the program's batch is fixed at its traced shape: the serving
        # batch, padded as Predictor pads
        chunk = pad_chunk({k: v[:args.serve_batch] for k, v in batch.items()},
                          args.serve_batch)
        t0 = time.perf_counter()
        export_forward(predictor.model, args.model_name, chunk, args.export,
                       quantize=quantize)
        print(f"wrote exported program {args.export} in "
              f"{time.perf_counter() - t0:.1f} s")
    if args.output:
        np.save(args.output, probs)
        print(f"wrote {args.output}")
    return probs


if __name__ == "__main__":
    main()
