from deep_recommenders_torch.models.nlp.attention import (
    Dense,
    MultiHeadAttention,
    TokenEmbedding,
)
from deep_recommenders_torch.models.nlp.transformer import (
    DecoderLayer,
    EncoderLayer,
    PositionWiseFeedForward,
    Transformer,
    noam_schedule,
    position_encoding,
)
