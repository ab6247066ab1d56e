from deep_recommenders_torch.training.data import DeviceData, gather_rows
from deep_recommenders_torch.training.evaluation import (
    BinaryCTREval,
    MultiTaskBCEEval,
    MultiTaskMSEEval,
    RetrievalEval,
    multitask_mse_loss,
    retrieval_loss,
)
from deep_recommenders_torch.training.losses import (
    binary_cross_entropy,
    label_smoothing,
    mean_squared_error,
    smoothed_sparse_softmax_cross_entropy,
    softmax_cross_entropy,
    tied_smoothed_sparse_softmax_cross_entropy,
)
from deep_recommenders_torch.training.metrics import (
    AUC,
    Mean,
    PrecisionRecall,
    binary_accuracy,
)
from deep_recommenders_torch.training.trainer import Trainer, bce_loss
from deep_recommenders_torch.training.checkpoints import (
    latest_step_dir,
    list_step_dirs,
    restore_checkpoint,
    restore_train_state,
    save_checkpoint,
    save_train_state,
)
from deep_recommenders_torch.training.optimizers import (
    Adagrad,
    Adam,
    Ftrl,
    scoped_optimizer,
)
from deep_recommenders_torch.training.warmstart import warm_start_from
