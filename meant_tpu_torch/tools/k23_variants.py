"""Where K3's and K2's time goes, on the card: the shipped bf16 kernels
against variants built from patched copies of csrc/.

    python -m meant_tpu_torch.tools.k23_variants [--kernels K3 K2]

K3 alone (on R1's Qr and Kr) at src4096's launch (BH=80, s=4096, bf16,
causal xPos; chip_smoke.py's long case), and K2 alone at the flagship's
(BH=640, s=512 causal xPos and s=196 pixel rotary; chip_smoke.py's
backward cases), with CUDA events, one line per variant:

* shipped: the kernels as they are (K3: one consumer warpgroup, a ring
  of two stages);
* K3 two_groups: two consumer warpgroups (128 q rows) a block, both
  reading each stage;
* K3 three_stages and two_groups_three_stages: a ring of three stages,
  with one and two warpgroups (the latter K3's first wgmma design);
* masked_everywhere: every tile masks element by element, as the diagonal
  and ragged tiles do;
* no_exp: P from S - m instead of exp(S - m), the exponential's cost
  (wrong results: timing only);
* K2 plain_epilogue: dq and dk stored without the rotation's adjoint,
  which reads the fp32 tables (wrong results: timing only);
* K2 two_stages: a ring of two stages instead of three, in the wgmma
  bodies K2 shares with K4 and K5 (tools/k45_variants.py's patches).
"""

from __future__ import annotations

import argparse
import json

import torch

import chip_smoke
from meant_tpu_torch.ops.flash import kernel
from meant_tpu_torch.tools.k2_faults import patched_sources, use_sources
from meant_tpu_torch.tools.k45_variants import BWD_VARIANTS

FWD = "flash_fwd.cu"
_TWO_GROUPS = (FWD, "constexpr int kFwdGroups = 1;",
               "constexpr int kFwdGroups = 2;")
_THREE_STAGES = (FWD, "constexpr int kFwdStages = 2;",
                 "constexpr int kFwdStages = 3;")
K3_VARIANTS = {
    "shipped": [],
    "two_groups": [_TWO_GROUPS],
    "three_stages": [_THREE_STAGES],
    "two_groups_three_stages": [_TWO_GROUPS, _THREE_STAGES],
    "masked_everywhere": [
        (FWD, "return (causal && it == qt) || k0 + kBlockK > seq_k;",
         "return true;")],
    "no_exp": [
        (FWD, "p[e] = (kEdge && x == -INFINITY) ? 0.f : expf(x - m_use[h]);",
         "p[e] = (kEdge && x == -INFINITY) ? 0.f : (x - m_use[h]);")],
}
K2_VARIANTS = dict(BWD_VARIANTS, plain_epilogue=[
    ("flash_common.cuh", "float g0, float g1) {\n  out[c] = from_f<T>(",
     "float g0, float g1) {\n  if (true) {\n    out[c] = from_f<T>(g0);\n"
     "    out[c + 1] = from_f<T>(g1);\n    return;\n  }\n"
     "  out[c] = from_f<T>(")])


def _variant(kernel_name: str, name: str, patches, library: str, launchers):
    label = f"{kernel_name}_{name}"
    use_sources(patched_sources(label, {label: patches}), library, launchers)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="+", choices=("K3", "K2"),
                    default=("K3", "K2"))
    kernels = ap.parse_args(argv).kernels
    if not torch.cuda.is_available():
        raise SystemExit("k23_variants runs on the card")
    card = chip_smoke.card_line()
    gen = torch.Generator(device="cuda").manual_seed(9)
    if "K3" in kernels:
        time_k3(gen, card)
    if "K2" in kernels:
        time_k2(gen, card)


def time_k3(gen, card) -> None:
    c = chip_smoke.long_case("text", torch.bfloat16, gen,
                             chip_smoke.LONG_TIME_BH)
    chip_smoke.rotate_case(c)
    for name, patches in K3_VARIANTS.items():
        _variant("k3", name, patches, "flash_fwd",
                 [kernel.flash_fwd, kernel.flash_fwd_online])
        ms = chip_smoke.event_ms(lambda: chip_smoke.run_online_k3(c),
                                 iters=30)
        print(json.dumps({"kernel": "K3", "variant": name, "shape":
                          list(c["q"].shape), "ms": ms, "card": card}),
              flush=True)
    del c
    torch.cuda.empty_cache()


def time_k2(gen, card) -> None:
    cases = {kind: chip_smoke.backward_case(kind, torch.bfloat16, gen)
             for kind in ("text", "vision")}
    for c in cases.values():
        chip_smoke.rotate_case(c)
    for name, patches in K2_VARIANTS.items():
        _variant("k2", name, patches, "flash_bwd", [kernel.flash_bwd])
        for kind, c in cases.items():
            ms = chip_smoke.event_ms(lambda: chip_smoke.run_bwd_k2(c),
                                     iters=30)
            print(json.dumps({"kernel": "K2", "variant": name, "shape":
                              list(c["q"].shape), "ms": ms, "card": card}),
                  flush=True)


if __name__ == "__main__":
    main()
