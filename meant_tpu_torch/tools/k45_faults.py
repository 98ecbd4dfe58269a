"""Deliberate-fault check of K4's and K5's bf16 bars, on the card.

    python -m meant_tpu_torch.tools.k45_faults     (from the repo root)

Builds patched copies of csrc/ (under meant_tpu_torch/_build/faults/) with
one fault each in the wgmma bodies of csrc/flash_bwd_wgmma.cuh (the
flash_bwd_online library's K4 and K5; K2 shares them), runs R1,
K4 and K5 from them at src4096's shapes in bf16 (chip_smoke.py's long
cases: s=4096, BH=16, causal xPos, without and with a padding mask) and
prints each gradient's error against the plain versions and whether the
bars of ops/flash/kernel.py catch it. The faults:

* ds_round_to_zero: dS rounded toward zero instead of to nearest, in K4
  and K5 (moves dq and dk, leaves dv);
* dq_transpose_bit: K4's dQr += dS Kr reads Kr with the transpose bit
  clear, K-major through the MN-major descriptor (moves dq).
"""

from __future__ import annotations

import json

import torch

import chip_smoke
from meant_tpu_torch.ops.flash import kernel
from meant_tpu_torch.tools.k2_faults import (DS_ROUND_TO_ZERO, bars,
                                             patched_sources, use_sources)

FAULTS = {
    "ds_round_to_zero": DS_ROUND_TO_ZERO,
    "dq_transpose_bit": [
        ("flash_bwd_wgmma.cuh",
         "wgmma_m64nNk16_rs<L::kCols, kMNMajor>(\n          dq_acc, ds[kk],",
         "wgmma_m64nNk16_rs<L::kCols, kKMajor>(\n          dq_acc, ds[kk],")],
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k45_faults runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in FAULTS:
        use_sources(patched_sources(name, FAULTS), "flash_bwd_online",
                    [kernel.rotate_qk, kernel.flash_bwd_dq,
                     kernel.flash_bwd_dkdv])
        gen = torch.Generator(device="cuda").manual_seed(4)
        for kind in ("text", "text_masked"):
            c = chip_smoke.long_case(kind, torch.bfloat16, gen,
                                     chip_smoke.LONG_CHECK_BH)
            chip_smoke.rotate_case(c)
            got = [chip_smoke.run_online_dq_kernel(c),
                   *chip_smoke.run_online_dkdv_kernel(c)]
            want = [chip_smoke.run_online_dq_plain(c),
                    *chip_smoke.run_online_dkdv_plain(c)]
            print(f"{name} long_{kind}: {json.dumps(bars(got, want))}",
                  flush=True)
            del c, got, want
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
