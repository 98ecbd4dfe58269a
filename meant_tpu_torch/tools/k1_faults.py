"""Deliberate-fault check of K1's bf16 bars, on the card.

    python -m meant_tpu_torch.tools.k1_faults     (from the repo root)

Builds patched copies of csrc/ (under meant_tpu_torch/_build/faults/) with
one fault each in K1's wgmma body (csrc/flash_fwd.cu), runs R1 + K1 from
them at the flagship's shapes in bf16 (chip_smoke.py's cases: BH=640,
s=512 causal xPos without and with a padding mask, s=196 pixel rotary),
and prints out's error against `flash_mha_reference` and whether the bars
of ops/flash/kernel.py catch it: K1_BF16_REL_L2 (K1's own) and
BF16_REL_L2 (the bar K1 had while it rounded P at a running max). The
shipped kernel is printed first. The faults:

* p_running_max: one online pass, P rounded at the running max and the
  output divided at the end -- K1's rule before its statistics pass, and
  K3's (moves out by rounding only);
* v_kmajor: O += P V reads V with the transpose bit clear, K-major through
  the MN-major descriptor;
* stats_no_diagonal: the statistics pass leaves out each q tile's diagonal
  tile (causal only: the pixel case is not moved).
"""

from __future__ import annotations

import json

import torch

import chip_smoke
from meant_tpu_torch.ops.flash import kernel
from meant_tpu_torch.tools.k2_faults import patched_sources, use_sources

SOURCE = "flash_fwd.cu"
FAULTS = {
    "shipped": [],
    "p_running_max": [
        (SOURCE, "fwd_wgmma<true, D, kGroups, kStages, kSplit, kOCols>(",
         "fwd_wgmma<false, D, kGroups, kStages, kSplit, kOCols>("),
        (SOURCE, "if (!kStats && col0 == 0 && t == 0)\n      lse[",
         "if (!kStats && col0 == 0 && t == 0 && lse != nullptr)\n      lse[")],
    "v_kmajor": [
        (SOURCE, "wgmma_m64nNk16_rs<kOCols, kMNMajor>(o_acc, pa[kk],",
         "wgmma_m64nNk16_rs<kOCols, kKMajor>(o_acc, pa[kk],")],
    "stats_no_diagonal": [
        (SOURCE, "if (it >= own_tiles) {  // past this warpgroup's diagonal",
         "if (it >= own_tiles - causal) {")],
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_faults runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    for name in FAULTS:
        use_sources(patched_sources(name, FAULTS), "flash_fwd",
                    [kernel.flash_fwd, kernel.flash_fwd_online])
        gen = torch.Generator(device="cuda").manual_seed(0)
        for kind in ("text", "vision", "text_masked"):
            c = chip_smoke.attention_case(kind, torch.bfloat16, gen)
            out = chip_smoke.run_kernel(c)
            ref = chip_smoke.run_plain(c)
            rel = chip_smoke.rel_l2(out, ref)
            res = {
                "rel_l2": rel,
                "max_abs": (out.float() - ref.float()).abs().max().item(),
                "finite": bool(torch.isfinite(out).all()),
                "caught_per_element": not torch.allclose(
                    out.float(), ref.float(), rtol=chip_smoke.BF16_TOL,
                    atol=chip_smoke.BF16_TOL),
                "caught_k1_rel_l2": not rel <= kernel.K1_BF16_REL_L2,
                "caught_bf16_rel_l2": not rel <= kernel.BF16_REL_L2,
                "card": card}
            print(f"{name} {kind}: {json.dumps(res)}", flush=True)
            del c, out, ref
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
