from .meant import (EmbeddingConfig, MlpHead, meant, meant_tweet,
                    meant_tweet_no_lag, meant_vision, meant_vqa, meantPrice)
from .meant_src import SeqProjection, meant_src

__all__ = ["EmbeddingConfig", "MlpHead", "SeqProjection", "meant",
           "meantPrice", "meant_src", "meant_tweet", "meant_tweet_no_lag",
           "meant_vision", "meant_vqa"]
