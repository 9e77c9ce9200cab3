from eeg_gnn_tpu_torch.models.dcgru import (  # noqa: F401
    DCGRUConfig,
    dcgru_cell_apply,
    encoder_apply,
    encoder_configs,
    encoder_init,
    init_dcgru_cell,
)
from eeg_gnn_tpu_torch.models.dcrnn import (  # noqa: F401
    DCRNNClassifier,
    DCRNNConfig,
    last_relevant,
)
