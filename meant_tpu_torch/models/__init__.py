from .meant import (EmbeddingConfig, MlpHead, meant, meant_tweet,
                    meant_tweet_no_lag, meant_vision, meant_vqa, meantPrice)
from .meant_src import (LSTMEncoder, SeqProjection, meant_price, meant_src,
                        meantTweetPrice, mlpEncoder)
from .meant_timesformer import (AudioEncoder, meant_mean_pooling, meant_mosi,
                                meant_timesformer)
from .meant_v2 import meant_v2
from .pretrainers import (RobertaLMHead, meant_language_pretrainer,
                          meant_vision_pretrainer, pixel_shuffle)
from .teanet import teanet
from meant_tpu_torch.nn.roberta import (ViltWrapper, bertweet_wrapper,
                                        roberta_mlm_wrapper, vl_BERT_Wrapper)

__all__ = ["AudioEncoder", "EmbeddingConfig", "LSTMEncoder", "MlpHead",
           "RobertaLMHead", "SeqProjection", "ViltWrapper",
           "bertweet_wrapper", "meant", "meantPrice",
           "meantTweetPrice", "meant_language_pretrainer",
           "meant_mean_pooling", "meant_mosi", "meant_price", "meant_src",
           "meant_timesformer", "meant_tweet", "meant_tweet_no_lag",
           "meant_v2", "meant_vision", "meant_vision_pretrainer",
           "meant_vqa", "mlpEncoder", "pixel_shuffle",
           "roberta_mlm_wrapper", "teanet", "vl_BERT_Wrapper"]
