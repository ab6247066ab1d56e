from deep_recommenders_torch.models.retrieval.ann import (
    IVF,
    ApproxTopK,
    kmeans,
)
from deep_recommenders_torch.models.retrieval.factorized_top_k import (
    BruteForce,
    FactorizedTopK,
    InMemoryStreaming,
    Streaming,
    TopK,
    load_index,
    save_index,
)
from deep_recommenders_torch.models.retrieval.gcn import GCN, GCNLayer
from deep_recommenders_torch.models.retrieval.two_tower import (
    Retrieval,
    Tower,
    TwoTower,
)
