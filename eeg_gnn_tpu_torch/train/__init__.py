"""Training: losses, the optimizer and the supervised train step."""

from eeg_gnn_tpu_torch.train.losses import (  # noqa: F401
    bce_with_logits,
    cross_entropy,
)
from eeg_gnn_tpu_torch.train.optim import (  # noqa: F401
    Optimizer,
    clip_by_global_norm_,
    cosine_annealing_lr,
    make_optimizer,
)
from eeg_gnn_tpu_torch.train.step import (  # noqa: F401
    TrainStep,
    supervised_loss_fn,
)
