"""The CUDA flash kernel against its plain version, on the card. These tests
need an NVIDIA card and nvcc; elsewhere they skip. On the card:

    pytest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from meant_tpu_torch.ops import lang_freqs, pixel_freqs
from meant_tpu_torch.ops.flash import (flash_fwd, flash_mha,
                                       flash_mha_reference)
from meant_tpu_torch.ops.flash.flash_attention import _tables
from meant_tpu_torch.ops.flash.kernel import BF16_REL_L2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["xpos_causal", "pixel", "masked",
                                  "broadcast_mask", "identity"])
@pytest.mark.parametrize("s", [1, 63, 196, 512])
def test_kernel_matches_plain(cuda, dtype, case, s):
    d = 96
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(3, 2, s, d, generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    causal = case in ("xpos_causal", "masked", "broadcast_mask")
    tables = (None,) * 4
    if case != "identity":
        freqs = (pixel_freqs(48, device=cuda) if case == "pixel"
                 else lang_freqs(48, device=cuda))
        tables = _tables(s, d, freqs, case != "pixel", 512.0)
    mask = None
    if case in ("masked", "broadcast_mask"):
        rows = 3 if case == "masked" else 1
        mask = (torch.rand(rows, s, generator=gen, device=cuda) > 0.3).float()
        mask[:, 0] = 1.0
    before = flash_fwd.launches
    out = flash_mha(q, k, v, scale=0.1, causal=causal, attention_mask=mask,
                    qcos=tables[0], qsin=tables[1], kcos=tables[2],
                    ksin=tables[3])
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    if tables[0] is None:
        ones = torch.ones(s, d, device=cuda)
        tables = (ones, torch.zeros_like(ones)) * 2
    ref = flash_mha_reference(q, k, v, mask, *tables, scale=0.1,
                              causal=causal)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)
        rel = (out.float() - ref.float()).norm() / ref.float().norm()
        assert rel <= BF16_REL_L2
