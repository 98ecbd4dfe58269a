"""Deliberate-fault check of K3's bf16 bars, on the card.

    python -m meant_tpu_torch.tools.k3_faults     (from the repo root)

Builds patched copies of csrc/ (under meant_tpu_torch/_build/faults/) with
one fault each in K3's wgmma body (csrc/flash_fwd.cu), runs R1 + K3 from
them at src4096's shapes in bf16 (chip_smoke.py's long cases: s=4096,
BH=16, causal xPos, without and with a padding mask) and prints out's and
lse's errors against `flash_mha_online_reference`, out's against
`flash_mha_online_tiled_reference` (the plain version in K3's order), and
whether the bars of ops/flash/kernel.py catch them (BF16_REL_L2,
K3_TILED_REL_L2, LSE_ATOL). The shipped kernel is printed first. The
faults:

* v_kmajor: O += P V reads V with the transpose bit clear, K-major through
  the MN-major descriptor (moves out, leaves lse);
* p_normalised: P divided by the row's running denominator before it is
  rounded, the output kept normalised from tile to tile (rescaled by
  l_old / l_new) and not divided at the end -- the same function, with P
  rounded after normalising instead of at the running max as the
  reference's streaming kernel rounds it (moves out by rounding only: only
  the tiled bar sees it).
"""

from __future__ import annotations

import json

import torch

import chip_smoke
from meant_tpu_torch.ops.flash import kernel
from meant_tpu_torch.tools.k2_faults import patched_sources, use_sources

SOURCE = "flash_fwd.cu"
_RUNNING_MAX = """  float m_use[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float corr = rescale(m[h], row_max(mx[h]), m_use[h]);
    l[h] *= corr;
#pragma unroll
    for (int j = 0; j < kNo; ++j) {
      o[4 * j + 2 * h] *= corr;
      o[4 * j + 2 * h + 1] *= corr;
    }
  }
#pragma unroll
  for (int j = 0; j < kNs; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = s[4 * j + 2 * h + e];
        p[e] = (kEdge && x == -INFINITY) ? 0.f : expf(x - m_use[h]);
        l[h] += p[e];
      }
      pa[j >> 1][(j & 1) * 2 + h] = pack_pair(p[0], p[1]);
    }
}"""
_NORMALISED = """  float m_use[2], l_old[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float corr = rescale(m[h], row_max(mx[h]), m_use[h]);
    l[h] *= corr;
    l_old[h] = row_sum(l[h]);
  }
#pragma unroll
  for (int j = 0; j < kNs; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = (kEdge && x == -INFINITY) ? 0.f : expf(x - m_use[h]);
        l[h] += x;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_new = row_sum(l[h]);
    const float inv = l_new > 0.f ? 1.0f / l_new : 0.f;
#pragma unroll
    for (int j = 0; j < kNo; ++j) {
      o[4 * j + 2 * h] *= l_old[h] * inv;
      o[4 * j + 2 * h + 1] *= l_old[h] * inv;
    }
#pragma unroll
    for (int j = 0; j < kNs; ++j)
      pa[j >> 1][(j & 1) * 2 + h] =
          pack_pair(s[4 * j + 2 * h] * inv, s[4 * j + 2 * h + 1] * inv);
  }
}"""
FAULTS = {
    "shipped": [],
    "v_kmajor": [
        (SOURCE, "wgmma_m64nNk16_rs<kOCols, kMNMajor>(o_acc, pa[kk],",
         "wgmma_m64nNk16_rs<kOCols, kKMajor>(o_acc, pa[kk],")],
    "p_normalised": [
        (SOURCE, _RUNNING_MAX, _NORMALISED),
        (SOURCE, "(lt > 0.f ? 1.0f / lt : 0.f)", "1.f")],
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k3_faults runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    for name in FAULTS:
        use_sources(patched_sources(name, FAULTS), "flash_fwd",
                    [kernel.flash_fwd, kernel.flash_fwd_online])
        gen = torch.Generator(device="cuda").manual_seed(4)
        for kind in ("text", "text_masked"):
            c = chip_smoke.long_case(kind, torch.bfloat16, gen,
                                     chip_smoke.LONG_CHECK_BH)
            out, lse = chip_smoke.run_online_kernel(c)
            rel = chip_smoke.rel_l2(out, c["out"])
            rel_tiled = chip_smoke.rel_l2(
                out, chip_smoke.run_online_tiled_plain(c))
            lse_err = (lse - c["lse"]).abs().max().item()
            res = {
                "rel_l2": rel,
                "max_abs": (out.float() - c["out"].float()).abs().max().item(),
                "caught_per_element": not torch.allclose(
                    out.float(), c["out"].float(), rtol=chip_smoke.BF16_TOL,
                    atol=chip_smoke.BF16_TOL),
                "caught_rel_l2": rel > kernel.BF16_REL_L2,
                "rel_l2_tiled": rel_tiled,
                "caught_tiled": not rel_tiled <= kernel.K3_TILED_REL_L2,
                "lse_max_abs": lse_err,
                "caught_lse": lse_err > kernel.LSE_ATOL, "card": card}
            print(f"{name} long_{kind}: {json.dumps(res)}", flush=True)
            del c, out, lse
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
