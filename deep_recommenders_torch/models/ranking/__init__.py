from deep_recommenders_torch.models.ranking.deepfm import DeepFM
