from .attention import attend, merge_heads, split_heads
from .norms import layer_norm, rms_norm
from .patch import patchify
from .rotary import (apply_rot_emb_sincos, apply_rotary,
                     axial_rotary_sincos, frame_rotary_sincos, lang_freqs,
                     pixel_freqs, rope_angles, rotate_half,
                     rotate_queries_and_keys, rotate_queries_or_keys,
                     xpos_scale)
from .temporal import lag_attend

__all__ = [
    "attend", "merge_heads", "split_heads", "layer_norm", "rms_norm",
    "patchify", "apply_rot_emb_sincos", "apply_rotary",
    "axial_rotary_sincos", "frame_rotary_sincos", "lang_freqs",
    "pixel_freqs", "rope_angles", "rotate_half", "rotate_queries_and_keys", "rotate_queries_or_keys",
    "xpos_scale", "lag_attend",
]
