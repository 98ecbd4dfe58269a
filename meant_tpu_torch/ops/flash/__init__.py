from .flash_attention import flash_attention
from .kernel import (flash_bwd, flash_bwd_dkdv, flash_bwd_dq, flash_fwd,
                     flash_fwd_online, flash_mha, flash_mha_bwd_online_reference,
                     flash_mha_bwd_reference, flash_mha_online_reference,
                     flash_mha_reference, rotate_qk, uses_online)

__all__ = ["flash_attention", "flash_bwd", "flash_bwd_dkdv", "flash_bwd_dq",
           "flash_fwd", "flash_fwd_online", "flash_mha",
           "flash_mha_bwd_online_reference", "flash_mha_bwd_reference",
           "flash_mha_online_reference", "flash_mha_reference", "rotate_qk",
           "uses_online"]
