"""Where `chip_smoke.py`'s time goes, phase by phase, to compare two trees
of the port on one card.

    python3 meant_tpu_torch/tools/smoke_phases.py --root DIR --out F

runs DIR's `chip_smoke.py` (its `main`, from DIR, its record written
under DIR/runs/smoke_phases, which git ignores) with each step that
`main` calls timed on the host clock: the checks, the phases and the
timing passes, each named by its function; a step that one of them calls
inside it counts within it.
Its own output goes where chip_smoke's goes. Then it prints one JSON line
(and appends it to F): the tree, chip_smoke's exit code, its wall and
build seconds, the card's name and power limit, and `phase_s`, the
seconds of each step. Run it on a parent and a change in one call, each
from a fresh checkout, so both build every kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

# the steps chip_smoke.main calls, in its order
STEPS = ("check_kernel", "check_backward", "check_long_kernels",
         "run_slice", "check_adamw", "run_training", "run_long",
         "run_paper", "run_pretrain", "run_levers", "run_zoo",
         "run_shapes", "run_hf_vqa", "run_ner", "run_buckets",
         "run_layouts", "run_head_dims", "time_kernels",
         "time_long_kernels", "time_shapes", "time_buckets",
         "time_layouts", "time_head_dims", "time_requests",
         "profile_calls")


def timed_steps(module, names, seconds: dict) -> None:
    """Wrap each of `names` in `module` so that a call made outside every
    other wrapped call adds its host time to seconds[name]."""
    depth = [0]

    def wrap(name, fn):
        def timed(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                seconds[name] = (seconds.get(name, 0.0)
                                 + time.perf_counter() - t0)
        return timed

    for name in names:
        setattr(module, name, wrap(name, getattr(module, name)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="tree whose chip_smoke.py to run")
    ap.add_argument("--out", default=None, help="append the JSON line here")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    out = os.path.abspath(args.out) if args.out else None
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke
    seconds: dict = {}
    timed_steps(chip_smoke, STEPS, seconds)
    record_dir = os.path.join(root, "runs", "smoke_phases")
    try:
        rc = chip_smoke.main(["--out", record_dir])
    except Exception:           # a failed check raises; its phases count
        traceback.print_exc()
        rc = 1
    record = {}
    path = os.path.join(record_dir, "chip_smoke.json")
    if os.path.exists(path):
        with open(path) as f:
            record = json.load(f)
    line = json.dumps({"root": root, "rc": rc,
                       "card": record.get("card"),
                       "wall_s": record.get("wall_s"),
                       "build_s": record.get("build_s"),
                       "phase_s": seconds})
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")
    return 0 if rc == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
