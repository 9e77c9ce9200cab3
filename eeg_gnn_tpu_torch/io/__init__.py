from eeg_gnn_tpu_torch.io.jax_params import (  # noqa: F401
    load_jax_npz,
    params_from_jax,
)
