from deep_recommenders_torch.training.data import DeviceData, gather_rows
from deep_recommenders_torch.training.evaluation import BinaryCTREval
from deep_recommenders_torch.training.losses import binary_cross_entropy
from deep_recommenders_torch.training.metrics import AUC, Mean, PrecisionRecall
from deep_recommenders_torch.training.trainer import Trainer, bce_loss
