from eeg_gnn_tpu_torch.models.dcgru import (  # noqa: F401
    DCGRUConfig,
    DCGRUDecoder,
    dcgru_cell_apply,
    dcgru_cell_apply_ops,
    decoder_apply,
    decoder_init,
    encoder_apply,
    encoder_configs,
    encoder_init,
    init_dcgru_cell,
)
from eeg_gnn_tpu_torch.models.dcrnn import (  # noqa: F401
    DCRNNClassifier,
    DCRNNConfig,
    DCRNNNextTimePred,
    compute_sampling_threshold,
    last_relevant,
)
