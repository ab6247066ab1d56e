from deep_recommenders_torch.models.ranking.deepfm import DeepFM
from deep_recommenders_torch.models.ranking.xdeepfm import CIN, XDeepFM
