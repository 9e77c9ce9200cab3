"""Training: losses, the optimizer and the train steps (supervised and
SSL pre-training)."""

from eeg_gnn_tpu_torch.train.losses import (  # noqa: F401
    bce_with_logits,
    compute_regression_loss,
    cross_entropy,
    masked_mae_loss,
    masked_mse_loss,
)
from eeg_gnn_tpu_torch.train.optim import (  # noqa: F401
    Optimizer,
    clip_by_global_norm_,
    cosine_annealing_lr,
    make_optimizer,
)
from eeg_gnn_tpu_torch.train.step import (  # noqa: F401
    TrainStep,
    ssl_loss_fn,
    supervised_loss_fn,
)
