from .attention_modules import (RotaryAttention, TemporalAttention,
                                XPosAttention)
from .embeddings import RobertaEmbeddings
from .encoders import LanguageEncoder, TemporalEncoder, VisionEncoder
from .layers import LayerNorm, Linear, RMSNorm, gelu, init_weights, make_norm

__all__ = [
    "RotaryAttention", "TemporalAttention", "XPosAttention",
    "RobertaEmbeddings", "LanguageEncoder", "TemporalEncoder",
    "VisionEncoder", "LayerNorm", "Linear", "RMSNorm", "gelu",
    "init_weights", "make_norm",
]
