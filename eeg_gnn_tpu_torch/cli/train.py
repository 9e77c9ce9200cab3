"""Training entry point: ``python -m eeg_gnn_tpu_torch.cli.train <flags>``.

The flags of ``python -m eeg_gnn_tpu.cli.train`` (the reference's
``train.py``/``train_ssl.py`` surface plus ``--marker_dir``,
``--adj_mat_dir``, ``--dtype`` and the JAX package's extensions), so one
command line serves both packages. It runs DCRNN detection and SSL
pre-training (and fine-tuning from an SSL checkpoint) on one CUDA card:
corpus markers -> clips -> FFT features -> per-clip graphs and supports
-> the train steps -> dev evaluation each epoch, best/last checkpoints,
early stopping -> the final dev and test results, written to
``results.json`` in a numbered run directory under ``--save_dir``.

``main(argv, device=None)`` runs on the card and raises without one;
``device="cpu"`` (a keyword, not a flag, as the JAX CLI picks its
platform from the environment) runs on the CPU.
"""

from __future__ import annotations

import json
import os
import sys


def main(argv=None, *, device=None, signals=None):
    """Parse ``argv`` (the process's arguments by default), train and
    evaluate; returns the test results.

    ``signals``: resampled signals by h5 path, for a corpus held in memory
    (``data/synthetic.make_synthetic_corpus(signals=...)``) on hosts
    without h5py.
    """
    from eeg_gnn_tpu_torch.config import ExperimentConfig, build_parser
    from eeg_gnn_tpu_torch.data.datasets import (
        load_dataset_detection,
        load_dataset_ssl,
    )
    from eeg_gnn_tpu_torch.device import resolve_device
    from eeg_gnn_tpu_torch.train.checkpoint import get_save_dir
    from eeg_gnn_tpu_torch.train.trainer import run_experiment
    from eeg_gnn_tpu_torch.utils.logging import MetricsWriter, get_logger

    parser = build_parser()
    parser.add_argument("--marker_dir", type=str, default=None,
                        help="Dir with file markers + scaler pickles.")
    parser.add_argument("--adj_mat_dir", type=str, default=None,
                        help="Path to distance-graph adjacency pickle.")
    ns = parser.parse_args(argv)
    d = vars(ns)
    marker_dir = d.pop("marker_dir")
    adj_mat_dir = d.pop("adj_mat_dir")
    cfg = ExperimentConfig(**d).finalize().check_runnable()
    device = resolve_device(device, "cli.train.main")

    save_dir = get_save_dir(cfg.save_dir or "./save", training=cfg.do_train)
    cfg.save_dir = save_dir
    with open(os.path.join(save_dir, "args.json"), "w") as f:
        f.write(cfg.to_json())
    log = get_logger(save_dir, "train")
    tbx = MetricsWriter(save_dir)
    try:
        log.info("Args: " + cfg.to_json())
        common = dict(
            input_dir=cfg.input_dir, raw_data_dir=cfg.raw_data_dir,
            train_batch_size=cfg.train_batch_size,
            test_batch_size=cfg.test_batch_size,
            time_step_size=cfg.time_step_size, standardize=True,
            num_workers=cfg.num_workers, augmentation=cfg.data_augment,
            adj_mat_dir=adj_mat_dir, graph_type=cfg.graph_type,
            top_k=cfg.top_k, filter_type=cfg.filter_type, use_fft=cfg.use_fft,
            marker_dir=marker_dir, signals=signals,
        )
        if cfg.task == "detection":
            loaders, _, scaler = load_dataset_detection(
                max_seq_len=cfg.max_seq_len,
                sampling_ratio=cfg.sampling_ratio, seed=123, **common)
        else:  # SS pre-training
            loaders, _, scaler = load_dataset_ssl(
                input_len=cfg.max_seq_len, output_len=cfg.output_seq_len,
                **common)
        results = run_experiment(cfg, loaders, scaler, save_dir, log, tbx,
                                 device=device)
    finally:
        tbx.close()
    with open(os.path.join(save_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
