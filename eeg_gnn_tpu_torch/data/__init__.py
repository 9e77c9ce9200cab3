"""The host data pipeline: synthetic corpus, markers, clips, FFT features,
augmentation, scaler, datasets and the threaded loader."""

from eeg_gnn_tpu_torch.data.scaler import StandardScaler  # noqa: F401
from eeg_gnn_tpu_torch.data.datasets import (  # noqa: F401
    DetectionDataset,
    SSLDataset,
    load_dataset_detection,
    load_dataset_ssl,
)
from eeg_gnn_tpu_torch.data.loader import DataLoader  # noqa: F401
