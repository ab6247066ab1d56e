from deep_recommenders_torch.embedding.engine import (
    SMALL_VOCAB_MAX,
    EmbeddingCollection,
    LinearTerms,
    fused_embedding_linear,
    fused_rows,
)
