from eeg_gnn_tpu_torch.io.jax_params import (  # noqa: F401
    load_jax_npz,
    load_params_like,
    params_from_jax,
    params_to_jax,
    state_to_jax,
)
from eeg_gnn_tpu_torch.io.torch_export import (  # noqa: F401
    export_classification_state,
    export_next_time_pred_state,
    save_torch_checkpoint,
)
from eeg_gnn_tpu_torch.io.torch_import import (  # noqa: F401
    import_classification_params,
    import_cnnlstm_params,
    import_densecnn_params,
    import_lstm_params,
    import_next_time_pred_params,
    import_params_for,
    load_torch_state_dict,
)
