"""Where K1's time goes, on the card: the shipped bf16 kernel against
variants built from patched copies of csrc/.

    python -m meant_tpu_torch.tools.k1_variants [--widths]

K1 alone (on R1's Qr and Kr) at the flagship's launches (BH=640, bf16:
s=512 causal xPos and s=196 pixel rotary; chip_smoke.py's cases), with
CUDA events, one line per variant and shape, with out's relative L2
against `flash_mha_reference`:

* shipped: the kernel as it is (one consumer warpgroup, a ring of two
  stages, a statistics pass then P = exp(S - m) * (1/l));
* three_stages: a ring of three stages;
* two_groups, two_groups_three_stages: two consumer warpgroups (128 q rows)
  a block, both reading each stage, with two and three stages;
* masked_everywhere: every tile masks element by element, as the diagonal
  and ragged tiles do;
* division: P = exp(S - m) / l, torch.softmax's division, instead of the
  product with 1/l (one fp32 rounding less);
* no_exp: exp(x) replaced by x in both passes (wrong results: timing
  only);
* one_pass (s=196 only: four tiles, not causal; d up to 128): no
  statistics pass; the four S tiles of a row block held in registers (64
  x 256 fp32, 128 registers a thread), m and l found over them, then P
  normalised and O += P V from a ring of four stages that holds every Kr
  and V tile.

--widths: K1 alone past d = 128 at meant_src's launches, (320, 512, 192)
and (240, 512, 256) causal xPos (--num_heads 4 and 3), (320, 196, 192)
pixel rotary, (160, 512, 384) causal xPos (--num_heads 2) and (80, 196,
768) pixel rotary (--num_heads 1), and K3 alone, which shares the sliced
ring, at (80, 512, 768) causal xPos (--num_heads 1's text tower) and
(20, 4096, 384) (src4096 at 2 heads); each variant at the widths it
changes, all variants built at once:

* shipped: at 192 two q-row groups a block, at 256 one, a ring of two
  stages, each consumer warpgroup holding all of O's columns; at 384 and
  768 the sliced ring (O's columns in groups of 384 on the grid, Kr in
  384-column slices), one q-row group of two consumer warpgroups a block,
  each holding 192 of the group's columns and forming the rows' whole S;
  as many 48 KB stages as fit (three at 384, two at 768);
* one_group (192): one q-row group a block;
* three_stages (192, 256): a ring of three stages;
* split_columns (192, 256): one q-row group, two warpgroups splitting O's
  columns, each forming the whole S;
* sliced_one_warpgroup (384, 768): one consumer warpgroup a block holding
  192 columns (groups of 192 on the grid, 192-column slices, as many 24
  KB stages as fit): each Kr slice read by one warpgroup, not two;
* sliced_two_groups (384): that, with two q-row groups a block.
"""

from __future__ import annotations

import argparse
import json

import torch

import chip_smoke
from meant_tpu_torch import cuda_build
from meant_tpu_torch.ops.flash import kernel
from meant_tpu_torch.tools.k2_faults import patched_sources, use_sources

FWD = "flash_fwd.cu"
_TWO_GROUPS = (FWD, "constexpr int kResGroups = 1;",
               "constexpr int kResGroups = 2;")
_THREE_STAGES = (FWD, "constexpr int kResStages = 2;",
                 "constexpr int kResStages = 3;")
# The one-pass body, in front of the statistics pass it switches off.
_ONE_PASS = """  if constexpr (kStats && D <= 128) {
    // one pass: every S tile in registers
    float sa[4][4 * kNs], unused[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      zero_regs(sa[i]);
      if (i < n_tiles) {
        mbar_wait(&sm.full[i], 0);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_m64n64k16_ss(sa[i], kmajor_desc(sm.q[wg], kk),
                             kmajor_desc(sm.k[i], kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sa[i]);
        if (edge_tile(causal, i, qt, i * kBlockK, seq_k))
          stats_tile<true, false>(sa[i], sa[i], m, l, unused, row,
                                  i * kBlockK, t, seq_k, causal, km, scale);
        else
          stats_tile<false, false>(sa[i], sa[i], m, l, unused, row,
                                   i * kBlockK, t, seq_k, causal, km, scale);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lt = row_sum(l[h]);
      row_m[h] = (m[h] == -INFINITY) ? 0.f : m[h];
      row_il[h] = lt > 0.f ? 1.0f / lt : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n_tiles) {
        uint32_t pa[kBlockK / 16][4];
#pragma unroll
        for (int j = 0; j < kNs; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float p[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = sa[i][4 * j + 2 * h + e];
              p[e] = x == -INFINITY ? 0.f
                                    : p_of<true>(x, row_m[h], row_il[h]);
            }
            pa[j >> 1][(j & 1) * 2 + h] = pack_pair(p[0], p[1]);
          }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk)
          wgmma_m64nNk16_rs<D, kMNMajor>(o_acc, pa[kk],
                                         mnmajor_desc(sm.v[i], kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o_acc);
        fence_regs(pa);
      }
    }
  }
  if constexpr (kStats && D > 128) {
    // pass 1: each row's max and denominator"""
K1_VARIANTS = {
    "shipped": [],
    "three_stages": [_THREE_STAGES],
    "two_groups": [_TWO_GROUPS],
    "two_groups_three_stages": [_TWO_GROUPS, _THREE_STAGES],
    "masked_everywhere": [
        (FWD, "return (causal && it == qt) || k0 + kBlockK > seq_k;",
         "return true;")],
    "division": [   # row_il then holds l itself
        (FWD, "row_il[h] = lt > 0.f ? 1.0f / lt : 0.f;",
         "row_il[h] = lt > 0.f ? lt : 1.f;"),
        (FWD, ": p_of<true>(x, row_m[h], row_il[h]);",
         ": __fdiv_rn(p_of<false>(x, row_m[h], 1.f), row_il[h]);")],
    "no_exp": [
        ("flash_common.cuh", "const float e = expf(__fsub_rn(sc, m));",
         "const float e = __fsub_rn(sc, m);")],
    "one_pass": [
        (FWD, "constexpr int kResStages = 2;", "constexpr int kResStages = 4;"),
        (FWD, "constexpr int kPasses = kStats ? 2 : 1;",
         "constexpr int kPasses = kStats && D > 128 ? 2 : 1;"),
        (FWD, "const bool with_v = !kStats || it >= n_tiles;",
         "const bool with_v = D <= 128 || !kStats || it >= n_tiles;"),
        (FWD, "  if constexpr (kStats) {\n"
              "    // pass 1: each row's max and denominator", _ONE_PASS),
        (FWD, "for (int it = 0; it < n_tiles; ++it) {\n"
              "    const int k0 = it * kBlockK;\n    // a stage",
         "for (int it = 0; it < (kStats && D <= 128 ? 0 : n_tiles); ++it) {"
         "\n    const int k0 = it * kBlockK;\n    // a stage")],
}
ONE_TILE_ROW_ONLY = {"one_pass"}   # s <= 256 and not causal

# (patches, the padded widths they change; the first two also change K3's
# layout at 192 and 256, which it shares)
_ONE_GROUP = (FWD, "return D <= 192 ? 2 : 1;", "return 1;")
_ONE_WARPGROUP = (FWD, "constexpr int kSlicedSplit = 2;",
                  "constexpr int kSlicedSplit = 1;")
WIDE_VARIANTS = {
    "shipped": ([], (192, 256, 384, 768)),
    "one_group": ([_ONE_GROUP], (192,)),
    "split_columns": ([_ONE_GROUP, (FWD, "constexpr int kWideFwdSplit = 1;",
                                    "constexpr int kWideFwdSplit = 2;")],
                      (192, 256)),
    "three_stages": ([(FWD, "constexpr int kWideResStages = 2;",
                       "constexpr int kWideResStages = 3;")], (192, 256)),
    "sliced_one_warpgroup": ([_ONE_WARPGROUP], (384, 768)),
    "sliced_two_groups": ([_ONE_WARPGROUP, (
        FWD, "constexpr int kGroups = 1;  // q-row groups of 64 a block",
        "constexpr int kGroups = D == 384 ? 2 : 1;")], (384,)),
}


def wide_cases(gen) -> list:
    """(kernel, case) at the launches --widths times: K1's resident cases
    (attention_case), K3's streaming ones (long_case, with its plain
    out)."""
    rows = chip_smoke.BATCH * chip_smoke.LAG
    cases = [("K1", chip_smoke.attention_case(
        kind, torch.bfloat16, gen, s=s, bh=rows * heads,
        d=chip_smoke.DIM // heads, heads=heads))
        for kind, s, heads in (("text", chip_smoke.SEQ, 4),
                               ("vision", chip_smoke.N_PATCHES, 4),
                               ("text", chip_smoke.SEQ, 3),
                               ("text", chip_smoke.SEQ, 2),
                               ("vision", chip_smoke.N_PATCHES, 1))]
    long_rows = chip_smoke.LONG_BATCH * chip_smoke.LAG
    cases += [("K3", chip_smoke.long_case("text", torch.bfloat16, gen,
                                          bh, s=s, d=d, heads=heads))
              for bh, s, d, heads in ((rows, chip_smoke.SEQ, 768, 1),
                                      (long_rows * 2, chip_smoke.LONG_SEQ,
                                       384, 2))]
    for name, c in cases:
        if name == "K1":
            c["out"] = chip_smoke.run_plain(c)
        chip_smoke.rotate_case(c)
    return cases


def time_widths(card) -> None:
    """The --widths variants, all built before the first is timed."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    cases = wide_cases(gen)
    roots = {name: patched_sources(f"k1w_{name}", {f"k1w_{name}": patches})
             for name, (patches, _) in WIDE_VARIANTS.items()}
    cuda_build.build_all(["flash_fwd"], [(r / "csrc", r / "_build")
                                         for r in roots.values()])
    shipped = {}
    for name, (_, widths) in WIDE_VARIANTS.items():
        use_sources(roots[name], "flash_fwd",
                    [kernel.flash_fwd, kernel.flash_fwd_online])
        for i, (k, c) in enumerate(cases):
            if c["q"].shape[-1] not in widths:
                continue
            run = chip_smoke.run_k1 if k == "K1" else (
                lambda c=c: chip_smoke.run_online_k3(c)[0])
            out = run(c)
            shipped.setdefault(i, out)
            ms = chip_smoke.event_ms(lambda: run(c), iters=20)
            launcher = kernel.flash_fwd if k == "K1" else (
                kernel.flash_fwd_online)
            print(json.dumps({
                "kernel": k, "variant": name, "shape": list(c["q"].shape),
                "causal": c["causal"], "ms": ms,
                "body": launcher.last_source,
                "rel_l2": chip_smoke.rel_l2(out, c["out"]),
                "max_abs_vs_shipped": (out.float() - shipped[i].float())
                .abs().max().item(), "card": card}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", action="store_true",
                    help="time K1 and K3 past d = 128 instead")
    widths = ap.parse_args(argv).widths
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    if widths:
        time_widths(card)
        return
    gen = torch.Generator(device="cuda").manual_seed(9)
    cases = {kind: chip_smoke.attention_case(kind, torch.bfloat16, gen)
             for kind in ("text", "vision")}
    refs = {kind: chip_smoke.run_plain(c) for kind, c in cases.items()}
    for c in cases.values():
        chip_smoke.rotate_case(c)
    for name, patches in K1_VARIANTS.items():
        label = f"k1_{name}"
        use_sources(patched_sources(label, {label: patches}), "flash_fwd",
                    [kernel.flash_fwd, kernel.flash_fwd_online])
        for kind, c in cases.items():
            if name in ONE_TILE_ROW_ONLY and (c["causal"] or c["s"] > 256):
                continue
            rel = chip_smoke.rel_l2(chip_smoke.run_k1(c), refs[kind])
            ms = chip_smoke.event_ms(lambda: chip_smoke.run_k1(c), iters=30)
            print(json.dumps({"kernel": "K1", "variant": name, "shape":
                              list(c["q"].shape), "causal": c["causal"],
                              "ms": ms, "rel_l2": rel, "card": card}),
                  flush=True)


if __name__ == "__main__":
    main()
