from deep_recommenders_torch.features.columns import (
    WEIGHT_SUFFIX,
    Feature,
    FeatureEncoder,
    crc32_hash_bucket,
    vocab_lookup,
)
