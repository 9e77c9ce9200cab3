from eeg_gnn_tpu_torch.ops.cuda_decoder import (  # noqa: F401
    dcgru_decoder_bwd,
    dcgru_decoder_bwd_plain,
    dcgru_decoder_fwd,
    dcgru_decoder_fwd_plain,
    dcgru_decoder_recurrence,
)
from eeg_gnn_tpu_torch.ops.cuda_recurrent import (  # noqa: F401
    dcgru_dw_reduce,
    dcgru_layer_recurrence_fused,
    dcgru_layer_recurrence_xin,
    dcgru_recurrence_bwd,
    dcgru_recurrence_bwd_plain,
    dcgru_recurrence_fwd,
    dcgru_recurrence_fwd_plain,
    dcgru_recurrence_xin_bwd,
    dcgru_recurrence_xin_bwd_plain,
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
