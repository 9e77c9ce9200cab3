"""Experiment configuration: the JAX package's ``ExperimentConfig``
(``eeg_gnn_tpu/config.py``) with its fields, defaults and flag names, so
one command line serves both packages' ``cli.train``.

Derived-field rules reproduced (reference ``args.py:196-221``):
``maximize_metric`` from ``metric_name`` and ``filter_type`` from
``graph_type`` (``finalize``); an eval-only run requires a checkpoint
(``check_runnable``, which the CLI and ``run_experiment`` call).

The TPU tuning knobs ``batch_tile``, ``scan_unroll`` and ``fused_steps``
are accepted and ignored. The on-device input pipeline, the dataset
caches (resident and rotating) and ``--reflect_invariant`` are ported;
as in the JAX CLI they serve ``--model_name dcrnn`` only, and a baseline
accepts and ignores them. ``--mesh_shape data:N`` is the data-parallel
mesh over N ranks (``parallel/``). ``check_runnable`` refuses a
``graph`` axis with a ``ValueError``, as a deliberate deviation: the JAX
CLI ignores ``--mesh_shape`` (:data:`GRAPH_AXIS_CLI`). ``preproc_dir``
reads the clip caches of ``cli/preprocess.py`` (``data/datasets.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

from eeg_gnn_tpu_torch.constants import NUM_NODES


@dataclasses.dataclass
class ExperimentConfig:
    # General
    save_dir: Optional[str] = None
    load_model_path: Optional[str] = None
    do_train: bool = False
    rand_seed: int = 123
    task: str = "detection"  # detection | classification | SS pre-training
    fine_tune: bool = False

    # Input
    graph_type: str = "individual"  # individual | combined
    max_seq_len: int = 60
    output_seq_len: int = 12
    time_step_size: int = 1
    input_dir: Optional[str] = None
    raw_data_dir: Optional[str] = None
    preproc_dir: Optional[str] = None
    top_k: int = 3

    # Model
    model_name: str = "dcrnn"  # dcrnn | lstm | densecnn | cnnlstm
    num_nodes: int = NUM_NODES
    num_rnn_layers: int = 2
    pretrained_num_rnn_layers: int = 3
    rnn_units: int = 64
    dcgru_activation: str = "tanh"
    input_dim: int = 100
    num_classes: int = 1
    output_dim: int = 100
    max_diffusion_step: int = 2
    cl_decay_steps: int = 3000
    use_curriculum_learning: bool = False
    use_fft: bool = False

    # Training / test
    train_batch_size: int = 40
    test_batch_size: int = 128
    num_workers: int = 8
    dropout: float = 0.0
    eval_every: int = 1
    metric_name: str = "auroc"  # F1 | acc | loss | auroc
    lr_init: float = 3e-4
    l2_wd: float = 5e-4
    num_epochs: int = 100
    max_grad_norm: float = 5.0
    metric_avg: str = "weighted"
    data_augment: bool = False
    patience: int = 5
    sampling_ratio: float = 1.0  # detection train-split subsampling: keep
    # this fraction of seizure rows (negatives matched 1:1), the
    # reference's ``scale_ratio`` (dataloader_detection.py:89-118)

    # Extensions of the JAX package (no reference counterpart)
    dtype: str = "float32"  # stream dtype: float32 | bfloat16
    mesh_shape: str = "data:-1"  # the data-parallel mesh over the ranks
    device_pipeline: bool = False  # on-device input pipeline (raw clips)
    hbm_cache: bool = False  # device-resident dataset caches
    hbm_budget_gb: float = 12.0  # the caches' device budget: rotating past it
    reflect_invariant: bool = False  # shared-support reflection (combined
    # graph; a documented divergence, see data/device_pipeline.py)
    recurrence: str = "pallas"  # pallas (the CUDA kernels) | stacked | naive
    use_pallas: bool = False  # per-step loop whose hidden diffusion convs
    # run the fused diffusion-conv kernel (per-clip supports); overrides
    # recurrence and input_fusion in the encoder, as in the JAX package
    input_fusion: bool = True  # input diffusion + projection in-kernel
    scan_unroll: int = 1  # the JAX time loop's unroll factor: ignored
    fused_steps: int = 1  # the JAX package's steps per program: ignored
    batch_tile: int = 36  # the JAX package's TPU clip tile: ignored (the
    # CUDA kernels pick their plans by shape)

    # Derived
    maximize_metric: bool = True
    filter_type: str = "dual_random_walk"

    def finalize(self) -> "ExperimentConfig":
        """Apply the reference's derived-field rules (args.py:196-221)."""
        if self.metric_name == "loss":
            self.maximize_metric = False
        elif self.metric_name in ("F1", "acc", "auroc"):
            self.maximize_metric = True
        else:
            raise ValueError(f'Unrecognized metric name: "{self.metric_name}"')
        if self.graph_type == "individual":
            self.filter_type = "dual_random_walk"
        if self.graph_type == "combined":
            self.filter_type = "laplacian"
        return self

    def check_runnable(self) -> "ExperimentConfig":
        """The run rules of the training CLI: an eval-only run needs a
        checkpoint (the JAX ``finalize``'s rule, args.py:196-221), and the
        mesh has no graph axis (:data:`GRAPH_AXIS_CLI`)."""
        if self.load_model_path is None and not self.do_train:
            raise ValueError(
                "For evaluation only, please provide trained model checkpoint "
                "in argument load_model_path."
            )
        from eeg_gnn_tpu_torch.parallel.mesh import (
            check_axes,
            parse_mesh_shape,
        )

        names = parse_mesh_shape(self.mesh_shape, 1)[0]
        check_axes(names)
        if "graph" in names:
            raise ValueError(f"--mesh_shape {self.mesh_shape}: "
                             + GRAPH_AXIS_CLI)
        return self

    @property
    def raw_clips(self) -> bool:
        """Whether the loaders yield raw clips: ``--device_pipeline``
        serves DCRNN detection and SSL pre-training only (JAX
        cli/train.py:91-95); classification and the baselines read
        featurized clips."""
        return (self.device_pipeline and self.task != "classification"
                and self.model_name == "dcrnn")

    @property
    def device_cached(self) -> bool:
        """Whether ``--hbm_cache`` holds the splits on the device: for
        ``--model_name dcrnn`` only (JAX cli/train.py:104-112)."""
        return self.hbm_cache and self.model_name == "dcrnn"

    @property
    def num_supports(self) -> int:
        from eeg_gnn_tpu_torch.graphs.supports import num_supports_for

        return num_supports_for(self.filter_type)

    def dcrnn_config(self, num_rnn_layers: Optional[int] = None):
        from eeg_gnn_tpu_torch.models.dcrnn import DCRNNConfig

        return DCRNNConfig(
            input_dim=self.input_dim,
            output_dim=self.output_dim,
            rnn_units=self.rnn_units,
            num_rnn_layers=num_rnn_layers or self.num_rnn_layers,
            max_diffusion_step=self.max_diffusion_step,
            num_nodes=self.num_nodes,
            num_supports=self.num_supports,
            num_classes=self.num_classes,
            dcgru_activation=self.dcgru_activation,
            dropout=self.dropout,
            cl_decay_steps=self.cl_decay_steps,
            use_curriculum_learning=self.use_curriculum_learning,
            compute_dtype=self.dtype,
            recurrence=self.recurrence,
            input_fusion=self.input_fusion,
            use_pallas=self.use_pallas,
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=4, sort_keys=True)


# The JAX CLI never builds a graph axis: it makes data:<devices> whatever
# --mesh_shape says (eeg_gnn_tpu/cli/train.py:72-89), and no trainer path
# reads the axis. The port refuses it rather than ignore it.
GRAPH_AXIS_CLI = (
    "the training CLI trains data-parallel only, as the JAX package's "
    "does; the mesh's graph axis is reached through "
    "eeg_gnn_tpu_torch.parallel.sparse_model (make_sparse_train_step) and "
    "the dry run, python -m eeg_gnn_tpu_torch.entry")


def _add_bool_flag(parser, name, help_str):
    parser.add_argument(f"--{name}", default=False, action="store_true", help=help_str)


def build_parser() -> argparse.ArgumentParser:
    """CLI with the reference's flag names (args.py) plus the JAX package's
    extensions."""
    d = ExperimentConfig()
    p = argparse.ArgumentParser(
        "Train DCRNN-family models on TUH EEG data (PyTorch + CUDA).")

    p.add_argument("--save_dir", type=str, default=d.save_dir)
    p.add_argument("--load_model_path", type=str, default=d.load_model_path)
    _add_bool_flag(p, "do_train", "Whether to perform training.")
    p.add_argument("--rand_seed", type=int, default=d.rand_seed)
    p.add_argument("--task", type=str, default=d.task,
                   choices=("detection", "classification", "SS pre-training"))
    _add_bool_flag(p, "fine_tune", "Fine-tune from a pretrained SSL model.")

    p.add_argument("--graph_type", choices=("individual", "combined"),
                   default=d.graph_type)
    p.add_argument("--max_seq_len", type=int, default=d.max_seq_len)
    p.add_argument("--output_seq_len", type=int, default=d.output_seq_len)
    p.add_argument("--time_step_size", type=int, default=d.time_step_size)
    p.add_argument("--input_dir", type=str, default=d.input_dir)
    p.add_argument("--raw_data_dir", type=str, default=d.raw_data_dir)
    p.add_argument("--preproc_dir", type=str, default=d.preproc_dir)
    p.add_argument("--top_k", type=int, default=d.top_k)

    p.add_argument("--model_name", type=str, default=d.model_name,
                   choices=("dcrnn", "lstm", "densecnn", "cnnlstm"))
    p.add_argument("--num_nodes", type=int, default=d.num_nodes)
    p.add_argument("--num_rnn_layers", type=int, default=d.num_rnn_layers)
    p.add_argument("--pretrained_num_rnn_layers", type=int,
                   default=d.pretrained_num_rnn_layers)
    p.add_argument("--rnn_units", type=int, default=d.rnn_units)
    p.add_argument("--dcgru_activation", type=str, choices=("relu", "tanh"),
                   default=d.dcgru_activation)
    p.add_argument("--input_dim", type=int, default=d.input_dim)
    p.add_argument("--num_classes", type=int, default=d.num_classes)
    p.add_argument("--output_dim", type=int, default=d.output_dim)
    p.add_argument("--max_diffusion_step", type=int, default=d.max_diffusion_step)
    p.add_argument("--cl_decay_steps", type=int, default=d.cl_decay_steps)
    _add_bool_flag(p, "use_curriculum_learning", "Scheduled sampling for seq2seq.")
    _add_bool_flag(p, "use_fft", "Input is log-amplitude FFT features.")

    p.add_argument("--train_batch_size", type=int, default=d.train_batch_size)
    p.add_argument("--test_batch_size", type=int, default=d.test_batch_size)
    p.add_argument("--num_workers", type=int, default=d.num_workers)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--eval_every", type=int, default=d.eval_every)
    p.add_argument("--metric_name", type=str, default=d.metric_name,
                   choices=("F1", "acc", "loss", "auroc"))
    p.add_argument("--lr_init", type=float, default=d.lr_init)
    p.add_argument("--l2_wd", type=float, default=d.l2_wd)
    p.add_argument("--num_epochs", type=int, default=d.num_epochs)
    p.add_argument("--max_grad_norm", type=float, default=d.max_grad_norm)
    p.add_argument("--metric_avg", type=str, default=d.metric_avg)
    _add_bool_flag(p, "data_augment", "Random reflection + scaling augmentation.")
    p.add_argument("--patience", type=int, default=d.patience)
    p.add_argument("--sampling_ratio", type=float, default=d.sampling_ratio,
                   help="Detection train-split subsampling (the "
                        "reference's scale_ratio): keep this fraction of "
                        "seizure rows, negatives matched 1:1.")

    p.add_argument("--dtype", type=str, default=d.dtype,
                   choices=("float32", "bfloat16"))
    p.add_argument("--mesh_shape", type=str, default=d.mesh_shape,
                   help="Data-parallel mesh over the torch.distributed "
                        "ranks: data:-1 or data:<world size> (a graph "
                        "axis is still to port).")
    _add_bool_flag(p, "device_pipeline",
                   "On-device input pipeline: raw clips are featurized, "
                   "augmented, standardized and graphed on the card.")
    _add_bool_flag(p, "hbm_cache",
                   "Device-resident dataset caches (rotating past "
                   "--hbm_budget_gb).")
    p.add_argument("--hbm_budget_gb", type=float, default=d.hbm_budget_gb,
                   help="The dataset caches' device budget in GiB (with "
                        "--hbm_cache).")
    _add_bool_flag(p, "reflect_invariant",
                   "Combined graph: reflection as a node relabeling "
                   "(shared supports; a documented divergence).")
    _add_bool_flag(p, "use_pallas",
                   "The per-step encoder loop through the fused "
                   "diffusion-conv kernel.")
    p.add_argument("--scan_unroll", type=int, default=d.scan_unroll,
                   help="The JAX package's time-loop unroll: ignored.")
    p.add_argument("--fused_steps", type=int, default=d.fused_steps,
                   help="The JAX package's optimizer steps per program: "
                        "ignored (the same numerics).")
    p.add_argument("--recurrence", type=str, default=d.recurrence,
                   choices=("stacked", "naive", "pallas"),
                   help="DCGRU scan backend: the CUDA kernels (pallas), "
                        "the operator-stacked scan with its hand-written "
                        "BPTT, or the naive per-step diffusion.")
    p.add_argument("--no_input_fusion", dest="input_fusion",
                   action="store_false", default=d.input_fusion,
                   help="Hoist the input diffusion + projection out of the "
                        "recurrence kernels.")
    p.add_argument("--batch_tile", type=int, default=d.batch_tile,
                   help="The JAX package's TPU clip tile: ignored.")
    return p
