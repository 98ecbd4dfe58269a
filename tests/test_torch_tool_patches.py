"""The card tools' source patches against the sources they patch.

The fault and variant tools (meant_tpu_torch/tools/k1_faults.py, k2_faults,
k3_faults, k45_faults, k1_variants, k23_variants, k45_variants,
wide_sum_order) build patched copies of meant_tpu_torch/csrc/ on the card,
each patch a (file, old, new) replacement whose old text must occur
exactly once in csrc/<file> (`patched_sources` raises otherwise). A source
edit that moves such a text breaks the tool only on the card; this holds
every patch list to the sources here, with no nvcc: one case per list.
"""

from pathlib import Path

import pytest

import torch_threads
from meant_tpu_torch.tools import (k1_faults, k1_variants, k2_faults,
                                   k3_faults, k23_variants, k45_faults,
                                   k45_variants, wide_sum_order)

torch_threads.share_cores()

CSRC = Path(__file__).resolve().parents[1] / "meant_tpu_torch" / "csrc"


def _lists():
    """(case id, [(file, old, new), ...]) of every tool's patch lists."""
    dicts = {
        "k1_faults.FAULTS": k1_faults.FAULTS,
        "k2_faults.FAULTS": k2_faults.FAULTS,
        "k3_faults.FAULTS": k3_faults.FAULTS,
        "k45_faults.FAULTS": k45_faults.FAULTS,
        "k1_variants.K1_VARIANTS": k1_variants.K1_VARIANTS,
        "k1_variants.WIDE_VARIANTS": {
            name: patches
            for name, (patches, _) in k1_variants.WIDE_VARIANTS.items()},
        "k23_variants.K3_VARIANTS": k23_variants.K3_VARIANTS,
        "k23_variants.K3_WIDE_VARIANTS": k23_variants.K3_WIDE_VARIANTS,
        "k23_variants.K2_VARIANTS": k23_variants.K2_VARIANTS,
        "k23_variants.K2_WIDE_VARIANTS": k23_variants.K2_WIDE_VARIANTS,
        "k45_variants.BWD_VARIANTS": k45_variants.BWD_VARIANTS,
    }
    cases = [(f"{where}[{name}]", patches)
             for where, patches_by_name in dicts.items()
             for name, patches in patches_by_name.items()]
    cases += [(f"wide_sum_order.order_patch[{order}]", order)
              for order in wide_sum_order.BODIES]
    cases += [(f"wide_sum_order.{name}", getattr(wide_sum_order, name))
              for name in ("WIDE_K2_768", "WIDE_K45", "WIDE_K45_PS")]
    return cases


CASES = _lists()


@pytest.mark.parametrize("patches", [p for _, p in CASES],
                         ids=[name for name, _ in CASES])
def test_patch_texts_occur_once_in_the_sources(patches):
    """Each old text of the list occurs exactly once in its csrc/ file,
    and the file names are sources of the package."""
    if isinstance(patches, str):  # an order of wide_sum_order
        patches = wide_sum_order.order_patch(patches)
    for file, old, new in patches:
        path = CSRC / file
        assert path.is_file(), f"{file} is not in csrc/"
        count = path.read_text().count(old)
        assert count == 1, f"{old!r} occurs {count} times in {file}"
        assert old != new, f"a patch of {file} changes nothing"
