"""Where K4's and K5's time goes, on the card: the shipped bf16 kernels
against variants built from patched copies of csrc/ (their wgmma bodies
are in flash_bwd_wgmma.cuh, shared with K2: tools/k23_variants.py).

    python -m meant_tpu_torch.tools.k45_variants     (from the repo root)

Times K4 and K5 at src4096's launch (BH=80, s=4096, bf16, causal xPos;
chip_smoke.py's long case) with CUDA events, one line per variant:

* shipped: the kernels as they are;
* masked_everywhere: every tile masks element by element, as the
  diagonal and ragged tiles do (the first design of the wgmma kernels);
* no_exp: P = S - lse instead of exp(S - lse), the exponential's cost
  (wrong results: timing only);
* two_stages: a ring of two stages instead of three.

The patches are BWD_VARIANTS, which tools/k23_variants.py applies to K2.
"""

from __future__ import annotations

import json

import torch

import chip_smoke
from meant_tpu_torch.ops.flash import kernel
from meant_tpu_torch.tools.k2_faults import patched_sources, use_sources

SOURCE = "flash_bwd_wgmma.cuh"
BWD_VARIANTS = {
    "shipped": [],
    "masked_everywhere": [
        (SOURCE, "return (causal && tile == qt) || k0 + kTile > seq_k;",
         "return true;"),
        (SOURCE,
         "return (causal && it == 0) || q0 + kTile > seq_q || k0 + kTile > "
         "seq_k;", "return true;")],
    "no_exp": [
        ("flash_common.cuh", "const float e = expf(__fsub_rn(sc, m));",
         "const float e = __fsub_rn(sc, m);")],
    "two_stages": [
        (SOURCE, "constexpr int kStages = 3;", "constexpr int kStages = 2;")],
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k45_variants runs on the card")
    gen = torch.Generator(device="cuda").manual_seed(9)
    c = chip_smoke.long_case("text", torch.bfloat16, gen,
                             chip_smoke.LONG_TIME_BH)
    chip_smoke.rotate_case(c)
    card = chip_smoke.card_line()
    for name, patches in BWD_VARIANTS.items():
        use_sources(patched_sources(f"variant_{name}", {
            f"variant_{name}": patches}), "flash_bwd_online",
            [kernel.rotate_qk, kernel.flash_bwd_dq, kernel.flash_bwd_dkdv])
        k4 = chip_smoke.event_ms(lambda: chip_smoke.run_online_dq_kernel(c),
                                 iters=10)
        k5 = chip_smoke.event_ms(
            lambda: chip_smoke.run_online_dkdv_kernel(c), iters=10)
        print(json.dumps({"variant": name, "k4_ms": k4, "k5_ms": k5,
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
