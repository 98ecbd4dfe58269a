"""Where K3's and K2's time goes, on the card: the shipped bf16 kernels
against variants built from patched copies of csrc/.

    python -m meant_tpu_torch.tools.k23_variants [--kernels K3 K2 K3wide
                                                  K2wide]

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

K3wide: K3 alone at src4096's launches past d = 128, (40, 4096, 192) at
--num_heads 4 and (30, 4096, 256) at 3 (causal xPos), on the forward's
wgmma body at those widths:

* shipped: one consumer warpgroup for each 64 q rows, holding all of
  O's columns; two of them a block (128 q rows) at 192, one at 256; a
  ring of three stages;
* one_group: one such warpgroup a block at both widths;
* split_columns: two consumer warpgroups for the block's 64 q rows, each
  holding half of O's columns and forming the rows' whole S (1.5x the
  tensor work);
* two_stages: a ring of two stages;
* two_groups_two_stages: two q-row groups a block at both widths, two
  stages (three do not fit beside two groups at 256).

K2wide: K2 alone at --num_heads 2's launches, (160, 512, 384) causal xPos
and (160, 196, 384) pixel rotary, on the sliced kernels
(csrc/flash_bwd_wgmma.cuh; all variants built at once):

* shipped: Kr and V (Qr and dO) stream in 192-column slices, five stages;
  the dk/dv kernel holds 192 columns of dK and dV a block (two consumer
  warpgroups of 96, two column groups on the grid);
* slices_96: 96-column slices (nine stages, a deeper ring);
* dkdv_96: the dk/dv kernel holds 96 columns a block (one consumer
  warpgroup and a producer warp; four column groups);
* slices_96_dkdv_96: both.
"""

from __future__ import annotations

import argparse
import json

import torch

import chip_smoke
from meant_tpu_torch import cuda_build
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
_ONE_GROUP = (FWD, "return D <= 192 ? 2 : 1;", "return 1;")
_TWO_STAGES = (FWD, "constexpr int kWideFwdStages = 3;",
               "constexpr int kWideFwdStages = 2;")
K3_WIDE_VARIANTS = {
    "shipped": [],
    "one_group": [_ONE_GROUP],
    "split_columns": [_ONE_GROUP, (FWD, "constexpr int kWideFwdSplit = 1;",
                                   "constexpr int kWideFwdSplit = 2;")],
    "two_stages": [_TWO_STAGES],
    "two_groups_two_stages": [
        (FWD, "return D <= 192 ? 2 : 1;", "return 2;"), _TWO_STAGES],
}
_SLICES_96 = ("flash_bwd_wgmma.cuh", "constexpr int kSliceCols = 192;",
              "constexpr int kSliceCols = 96;")
_DKDV_96 = ("flash_bwd_wgmma.cuh", "constexpr int kSlicedDkdvCols = 192;",
            "constexpr int kSlicedDkdvCols = 96;")
K2_WIDE_VARIANTS = {
    "shipped": [],
    "slices_96": [_SLICES_96],
    "dkdv_96": [_DKDV_96],
    "slices_96_dkdv_96": [_SLICES_96, _DKDV_96],
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
    ap.add_argument("--kernels", nargs="+",
                    choices=("K3", "K2", "K3wide", "K2wide"),
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
    if "K3wide" in kernels:
        time_k3_wide(gen, card)
    if "K2wide" in kernels:
        time_k2_wide(gen, card)


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


def time_k3_wide(gen, card) -> None:
    rows = chip_smoke.LONG_BATCH * chip_smoke.LAG
    cases = [chip_smoke.long_case("text", torch.bfloat16, gen, rows * heads,
                                  d=d, heads=heads)
             for d, heads in ((192, chip_smoke.SRC4_HEADS),
                              (256, chip_smoke.SRC3_HEADS))]
    for c in cases:
        chip_smoke.rotate_case(c)
    shipped = []
    for name, patches in K3_WIDE_VARIANTS.items():
        _variant("k3wide", name, patches, "flash_fwd",
                 [kernel.flash_fwd, kernel.flash_fwd_online])
        for i, c in enumerate(cases):
            out, lse = chip_smoke.run_online_k3(c)
            if name == "shipped":
                shipped.append((out, lse))
            ms = chip_smoke.event_ms(lambda: chip_smoke.run_online_k3(c),
                                     iters=30)
            print(json.dumps({
                "kernel": "K3", "variant": name, "shape": list(c["q"].shape),
                "ms": ms, "body": kernel.flash_fwd_online.last_source,
                "out_vs_plain_rel_l2": chip_smoke.rel_l2(out, c["out"]),
                "out_max_abs_vs_shipped": (out.float() - shipped[i][0]
                                           .float()).abs().max().item(),
                "lse_max_abs_vs_shipped": (lse - shipped[i][1]).abs().max()
                .item(), "card": card}), flush=True)


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



def time_k2_wide(gen, card) -> None:
    rows = chip_smoke.BATCH * chip_smoke.LAG * 2
    cases = [chip_smoke.backward_case(kind, torch.bfloat16, gen, s=s,
                                      bh=rows, d=384, heads=2)
             for kind, s in (("text", chip_smoke.SEQ),
                             ("vision", chip_smoke.N_PATCHES))]
    for c in cases:
        chip_smoke.rotate_case(c)
    roots = {name: patched_sources(f"k2wide_{name}",
                                   {f"k2wide_{name}": patches})
             for name, patches in K2_WIDE_VARIANTS.items()}
    cuda_build.build_all(["flash_bwd"], [(r / "csrc", r / "_build")
                                         for r in roots.values()])
    shipped = []
    for name in K2_WIDE_VARIANTS:
        use_sources(roots[name], "flash_bwd", [kernel.flash_bwd])
        for i, c in enumerate(cases):
            grads = chip_smoke.run_bwd_k2(c)
            if name == "shipped":
                shipped.append(grads)
            ms = chip_smoke.event_ms(lambda: chip_smoke.run_bwd_k2(c),
                                     iters=20)
            print(json.dumps({
                "kernel": "K2", "variant": name, "shape":
                list(c["q"].shape), "ms": ms,
                "body": kernel.flash_bwd.last_source,
                "max_abs_vs_shipped": max(
                    (a.float() - b.float()).abs().max().item()
                    for a, b in zip(grads, shipped[i])),
                "card": card}), flush=True)


if __name__ == "__main__":
    main()
