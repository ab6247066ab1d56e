from deep_recommenders_torch.datasets.movielens import (
    MovielensRanking,
    default_movielens_features,
    load_ml1m,
    synthesize_ml1m,
)
