"""Experiment configuration: the fields of the JAX package's
``ExperimentConfig`` that the DCRNN model and the ``Predictor`` read.

Derived-field rule reproduced (reference ``args.py:196-221``):
``filter_type`` is forced from ``graph_type``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from eeg_gnn_tpu_torch.constants import NUM_NODES


@dataclasses.dataclass
class ExperimentConfig:
    task: str = "detection"  # detection | classification
    graph_type: str = "individual"  # individual | combined
    max_seq_len: int = 60

    model_name: str = "dcrnn"
    num_nodes: int = NUM_NODES
    num_rnn_layers: int = 2
    rnn_units: int = 64
    dcgru_activation: str = "tanh"
    input_dim: int = 100
    num_classes: int = 1
    max_diffusion_step: int = 2
    test_batch_size: int = 128
    dropout: float = 0.0

    dtype: str = "float32"  # stream dtype: float32 | bfloat16
    recurrence: str = "pallas"  # pallas (the CUDA kernels) | stacked
    input_fusion: bool = True  # input diffusion + projection in-kernel
    batch_tile: int = 36  # the JAX package's TPU clip tile; kept so one
    # config file serves both packages. The CUDA kernels run one clip per
    # thread block and do not read it.

    filter_type: str = "dual_random_walk"  # derived in finalize()

    def finalize(self) -> "ExperimentConfig":
        """Apply the reference's graph_type -> filter_type rule."""
        if self.graph_type == "individual":
            self.filter_type = "dual_random_walk"
        if self.graph_type == "combined":
            self.filter_type = "laplacian"
        return self

    @property
    def num_supports(self) -> int:
        from eeg_gnn_tpu_torch.graphs.supports import num_supports_for

        return num_supports_for(self.filter_type)

    def dcrnn_config(self, num_rnn_layers: Optional[int] = None):
        from eeg_gnn_tpu_torch.models.dcrnn import DCRNNConfig

        return DCRNNConfig(
            input_dim=self.input_dim,
            rnn_units=self.rnn_units,
            num_rnn_layers=num_rnn_layers or self.num_rnn_layers,
            max_diffusion_step=self.max_diffusion_step,
            num_nodes=self.num_nodes,
            num_supports=self.num_supports,
            num_classes=self.num_classes,
            dcgru_activation=self.dcgru_activation,
            dropout=self.dropout,
            compute_dtype=self.dtype,
            recurrence=self.recurrence,
            input_fusion=self.input_fusion,
        )
