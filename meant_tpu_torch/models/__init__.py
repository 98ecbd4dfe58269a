from .meant import EmbeddingConfig, MlpHead
from .meant_src import SeqProjection, meant_src

__all__ = ["EmbeddingConfig", "MlpHead", "SeqProjection", "meant_src"]
