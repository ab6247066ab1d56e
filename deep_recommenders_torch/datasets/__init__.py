from deep_recommenders_torch.datasets.imdb import SyntheticImdb
from deep_recommenders_torch.datasets.movielens import (
    MovielensRanking,
    default_movielens_features,
    load_ml1m,
    synthesize_ml1m,
)
from deep_recommenders_torch.datasets.synthetic_multitask import (
    SyntheticForMultiTask,
    synthetic_two_task,
)
