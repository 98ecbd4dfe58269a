from .flash_attention import flash_attention
from .kernel import (flash_bwd, flash_fwd, flash_mha, flash_mha_bwd_reference,
                     flash_mha_reference)

__all__ = ["flash_attention", "flash_bwd", "flash_fwd", "flash_mha",
           "flash_mha_bwd_reference", "flash_mha_reference"]
