"""Deliberate-fault check of K2's bf16 bars, on the card.

    python -m meant_tpu_torch.tools.k2_faults     (from the repo root)

Builds patched copies of csrc/ (under meant_tpu_torch/_build/faults/) with
one fault each, runs R1 + K2 from them at the main path's two shapes in
bf16 (chip_smoke.py's cases), and prints each gradient's error against
`flash_mha_bwd_reference` and whether the bars of ops/flash/kernel.py
catch it. The faults:

* adjoint_sign: the sine term of the rotation's adjoint with the wrong
  sign, cos*g + H(sin*g) (moves dq and dk, leaves dv and the forward);
* ds_round_to_zero: dS rounded toward zero instead of to nearest, in the
  wgmma bodies K2 shares with K4 and K5 (flash_bwd_wgmma.cuh).
"""

from __future__ import annotations

import json
import shutil

import torch

import chip_smoke
from meant_tpu_torch import cuda_build
from meant_tpu_torch.ops.flash import kernel

_PACK_RZ = """// dS rounded toward zero (the fault).
__device__ __forceinline__ uint32_t pack_pair_rz(float lo, float hi) {
  __nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rz(lo),
                                        __float2bfloat16_rz(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

// dS = T(p * (dp - delta) * scale) for two"""

# dS rounded toward zero in the wgmma bodies of K2, K4 and K5
DS_ROUND_TO_ZERO = [
    ("flash_bwd_wgmma.cuh", "return pack_pair(p0 * (dp0 - dl0) * scale,",
     "return pack_pair_rz(p0 * (dp0 - dl0) * scale,"),
    ("flash_bwd_wgmma.cuh", "// dS = T(p * (dp - delta) * scale) for two",
     _PACK_RZ)]

# (file in csrc/, text, replacement); the rotation's adjoint is the shared
# store_adjoint of flash_common.cuh
FAULTS = {
    "adjoint_sign": [("flash_common.cuh", "__fmul_rn(sin_row[c + 1], g1)));",
                      "__fmul_rn(-sin_row[c + 1], g1)));")],
    "ds_round_to_zero": DS_ROUND_TO_ZERO,
}


def patched_sources(name: str, faults=FAULTS):
    """A copy of the package's csrc/ with only the fault `name` of
    `faults` applied."""
    root = cuda_build.PACKAGE_DIR / "_build" / "faults" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(cuda_build.PACKAGE_DIR / "csrc", root / "csrc")
    for file, old, new in faults[name]:
        path = root / "csrc" / file
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} not found once in {file}")
        path.write_text(text.replace(old, new))
    return root


def use_sources(root, library: str, launchers) -> None:
    """Build and load `library` from the patched copy under root from now
    on, for every wrapper in `launchers`."""
    cuda_build.CSRC_DIR = root / "csrc"
    cuda_build.BUILD_DIR = root / "_build"
    cuda_build._loaded.pop(library, None)
    for launcher in launchers:
        launcher._fn = None


def bars(got, want) -> dict:
    """Each gradient's errors and whether the bf16 bars of
    ops/flash/kernel.py catch them."""
    res = {}
    for g, a, b in zip(("dq", "dk", "dv"), got, want):
        rel = chip_smoke.rel_l2(a, b)
        res[g] = {
            "rel_l2": rel,
            "max_abs": (a.float() - b.float()).abs().max().item(),
            "caught_per_element": not torch.allclose(
                a.float(), b.float(), rtol=chip_smoke.BF16_TOL,
                atol=kernel.BWD_BF16_ATOL),
            "caught_rel_l2": rel > kernel.BWD_BF16_REL_L2}
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k2_faults runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in FAULTS:
        use_sources(patched_sources(name), "flash_bwd", [kernel.flash_bwd])
        gen = torch.Generator(device="cuda").manual_seed(2)
        for kind in ("text", "vision"):
            c = chip_smoke.backward_case(kind, torch.bfloat16, gen)
            got = chip_smoke.run_bwd_kernel(c)
            want = chip_smoke.run_bwd_plain(c)
            print(f"{name} {kind}: {json.dumps(bars(got, want))}",
                  flush=True)
            del c, got, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
