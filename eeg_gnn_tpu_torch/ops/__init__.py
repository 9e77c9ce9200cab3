from eeg_gnn_tpu_torch.ops.cuda_recurrent import (  # noqa: F401
    dcgru_recurrence_fwd,
    dcgru_recurrence_fwd_plain,
    dcgru_recurrence_xin_fwd,
    dcgru_recurrence_xin_fwd_plain,
)
from eeg_gnn_tpu_torch.ops.diffusion import (  # noqa: F401
    chebyshev_diffusion,
    diffusion_conv,
)
from eeg_gnn_tpu_torch.ops.recurrent import (  # noqa: F401
    chebyshev_operators,
    dcgru_layer_recurrence,
    rearrange_hidden_weight,
)
