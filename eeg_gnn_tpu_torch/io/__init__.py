from eeg_gnn_tpu_torch.io.jax_params import (  # noqa: F401
    load_jax_npz,
    load_params_like,
    params_from_jax,
    params_to_jax,
)
