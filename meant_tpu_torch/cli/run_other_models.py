"""Baseline-model harness (counterpart of meant_tpu/cli/run_other_models.py),
with the same flag names.

    python -m meant_tpu_torch.cli.run_other_models -rid 0 -mn meant_tweet \
        [--seed 7] [--fixed_metrics] [--device cpu]
    python -m meant_tpu_torch.cli.run_other_models -rid 0 -hf true \
        -mn roberta_tweet -nc 15

As in the JAX harness:
  * only `meant`, `meant_vision` and `meant_tweet` build here (anything
    else raises 'Pass a valid model name.'), trained by
    `cli.in_loop_train`; `--hugging_face_model` hands the run to
    `cli.hug_train` instead;
  * the seed is 42 unless `--seed` is given (the reference's
    `torch.manual_seed(42)`);
  * `--fixed_metrics` is this harness's own flag, taken out before the run
    is handed on;
  * the test metrics are printed as the reference prints them, recall
    copied from precision (`run_other_models.py:85-86`, DEFECTS #27)
    unless `--fixed_metrics` asks for the true recall.
"""

from __future__ import annotations

import sys

from meant_tpu_torch.cli.common import base_parser, str2bool

SUPPORTED = ("meant", "meant_vision", "meant_tweet")
_BOOL_WORDS = ("yes", "true", "t", "y", "1", "no", "false", "f", "n", "0")


def _reference_metrics_block(m: dict, set_name: str,
                             fixed_metrics: bool) -> list:
    """The reference's `metrics.show()` lines, recall copied from
    precision unless `fixed_metrics`."""
    recall_macro = m["recall_macro" if fixed_metrics else "precision_macro"]
    recall_micro = m["recall_micro" if fixed_metrics else "precision_micro"]
    lines = [
        (set_name + " accuracy: ", m["accuracy"]),
        ("Macro " + set_name + " f1: ", m["f1_macro"]),
        ("Micro " + set_name + " f1: ", m["f1_micro"]),
        ("Macro " + set_name + " precision: ", m["precision_macro"]),
        ("Micro " + set_name + " precision: ", m["precision_micro"]),
        ("Macro " + set_name + " recall: ", recall_macro),
        ("Micro " + set_name + " recall: ", recall_micro),
    ]
    for label, value in lines:
        print(label, value)
    return lines


def forwarded(argv: list) -> list:
    """`argv` without `--fixed_metrics` and its boolean value, if any."""
    fwd, skip = [], False
    for i, a in enumerate(argv):
        if skip:
            skip = False
            continue
        if a.startswith("--fixed_metrics"):
            skip = ("=" not in a and i + 1 < len(argv)
                    and argv[i + 1].lower() in _BOOL_WORDS)
            continue
        fwd.append(a)
    return fwd


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = base_parser()
    parser.add_argument("--fixed_metrics", type=str2bool, nargs="?",
                        const=True, default=False,
                        help="report the true recall instead of the "
                             "reference's precision-for-recall copy")
    # None tells "absent" (42) from any value given, 0 included
    parser.set_defaults(seed=None)
    args = parser.parse_args(argv)
    fwd = forwarded(argv)
    if args.hugging_face_model:
        from meant_tpu_torch.cli.hug_train import main as hug_main
        return hug_main(fwd)
    if args.model_name not in SUPPORTED:
        raise ValueError("Pass a valid model name.")
    # the delegate parses fwd again: the last --seed wins there
    fwd += ["--seed", "42" if args.seed is None else str(args.seed)]
    from meant_tpu_torch.cli.in_loop_train import main as train_main
    results = train_main(fwd)
    if results.get("test"):
        _reference_metrics_block(results["test"], "test", args.fixed_metrics)
    return results


if __name__ == "__main__":
    main()
