from deep_recommenders_torch.datasets.cora import (
    Cora,
    download_cora,
    normalize_adjacency,
)
from deep_recommenders_torch.datasets.imdb import SyntheticImdb, load_imdb_npz
from deep_recommenders_torch.datasets.movielens import (
    MovielensRanking,
    default_movielens_features,
    download_ml1m,
    load_ml1m,
    synthesize_ml1m,
)
from deep_recommenders_torch.datasets.synthetic_multitask import (
    SyntheticForMultiTask,
    synthetic_two_task,
)
