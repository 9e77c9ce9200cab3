from eeg_gnn_tpu_torch.graphs.supports import (  # noqa: F401
    compute_supports,
    compute_supports_torch,
    normalized_laplacian,
    num_supports_for,
    random_walk,
    scaled_laplacian,
)
