from .meant import (EmbeddingConfig, MlpHead, meant, meant_tweet,
                    meant_tweet_no_lag, meant_vision, meant_vqa, meantPrice)
from .meant_src import SeqProjection, meant_src
from .pretrainers import (RobertaLMHead, meant_language_pretrainer,
                          meant_vision_pretrainer, pixel_shuffle)

__all__ = ["EmbeddingConfig", "MlpHead", "RobertaLMHead", "SeqProjection",
           "meant", "meantPrice", "meant_language_pretrainer", "meant_src",
           "meant_tweet", "meant_tweet_no_lag", "meant_vision",
           "meant_vision_pretrainer", "meant_vqa", "pixel_shuffle"]
