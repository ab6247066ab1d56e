from deep_recommenders_torch.models.ranking.dcn import DCN, Cross
from deep_recommenders_torch.models.ranking.deepfm import DeepFM
from deep_recommenders_torch.models.ranking.din import (
    DIN,
    ActivationUnit,
    Dice,
    subtract_interacter,
)
from deep_recommenders_torch.models.ranking.fm import (
    FactorizationMachine,
    FMLayer,
)
from deep_recommenders_torch.models.ranking.fnn import FNN
from deep_recommenders_torch.models.ranking.wide_deep import WideDeep
from deep_recommenders_torch.models.ranking.xdeepfm import CIN, XDeepFM
