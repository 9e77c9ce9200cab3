"""Training entry point: ``python -m eeg_gnn_tpu_torch.cli.train <flags>``.

The flags of ``python -m eeg_gnn_tpu.cli.train`` (the reference's
``train.py``/``train_ssl.py`` surface plus ``--marker_dir``,
``--adj_mat_dir``, ``--dtype`` and the JAX package's extensions), so one
command line serves both packages. It runs detection and seizure-type
classification with DCRNN or a baseline (``--model_name lstm``,
``cnnlstm``, ``densecnn``; the Dense-CNN's classification reads the
flat-clip dataset), SSL pre-training (and fine-tuning from an SSL
checkpoint, ``.npz`` or reference ``.pth.tar``) on one CUDA card:
corpus markers -> clips -> FFT features -> per-clip graphs and supports
-> the train steps -> dev evaluation each epoch, best/last checkpoints,
early stopping -> the final dev and test results, written to
``results.json`` in a numbered run directory under ``--save_dir``.

``--device_pipeline`` makes the loaders yield raw clips, featurized,
augmented, standardized and graphed on the device
(``data/device_pipeline.py``); as in the JAX CLI, it serves detection
and SSL only, and classification reads featurized clips.
``--hbm_cache`` featurizes every split once on the host and keeps it on
the device (``data/device_cache.py``), or, past ``--hbm_budget_gb``,
rotates it through the device in shards (``data/rotating_cache.py``):
all three tasks, both graph types. As in the JAX CLI, both serve
``--model_name dcrnn`` only: a baseline accepts them and streams host
features. ``--reflect_invariant`` is the JAX CLI's; ``--fused_steps`` is
accepted and ignored (``config.py``). The mesh branch of the JAX CLI
waits for its slice (ROADMAP.md, Queue 1).

``main(argv, device=None)`` runs on the card and raises without one;
``device="cpu"`` (a keyword, not a flag, as the JAX CLI picks its
platform from the environment) runs on the CPU.
"""

from __future__ import annotations

import json
import os
import sys


def input_path(cfg, scaler, *, adj_mat_dir=None, marker_dir=None,
               signals=None, device=None):
    """The on-device input path of ``cfg`` (the JAX CLI's, train.py:
    91-240, without the mesh): (the ``DevicePipeline`` or None, {split:
    cache} or None).

    ``--hbm_cache``: every split is featurized once from plain datasets
    (no augmentation, no standardization: both run on the device per
    step) and uploaded if the whole fits ``--hbm_budget_gb``
    (``fits_in_hbm``); otherwise each split becomes a rotating cache, as
    the JAX CLI does, and a line on stderr says so.
    """
    from eeg_gnn_tpu_torch.data.datasets import (
        load_dataset_classification,
        load_dataset_detection,
        load_dataset_ssl,
    )
    from eeg_gnn_tpu_torch.data.device_cache import (
        build_classification_cache,
        build_detection_cache,
        build_ssl_cache,
        fits_in_hbm,
    )
    from eeg_gnn_tpu_torch.data.device_pipeline import make_device_pipeline
    from eeg_gnn_tpu_torch.data.rotating_cache import build_rotating_cache

    if not (cfg.raw_clips or cfg.device_cached):
        return None, None
    pipeline = make_device_pipeline(
        graph_type=cfg.graph_type, filter_type=cfg.filter_type,
        top_k=cfg.top_k, use_fft=cfg.use_fft,
        time_step_size=cfg.time_step_size, scaler=scaler,
        augment=cfg.data_augment, adj_mat_dir=adj_mat_dir,
        num_nodes=cfg.num_nodes, reflect_invariant=cfg.reflect_invariant,
        device=device)
    if not cfg.device_cached:
        return pipeline, None

    plain_common = dict(
        input_dir=cfg.input_dir, raw_data_dir=cfg.raw_data_dir,
        train_batch_size=cfg.train_batch_size,
        test_batch_size=cfg.test_batch_size,
        time_step_size=cfg.time_step_size, standardize=False,
        num_workers=cfg.num_workers, augmentation=False,
        adj_mat_dir=None, graph_type=None, use_fft=cfg.use_fft,
        preproc_dir=cfg.preproc_dir, marker_dir=marker_dir,
        build_loaders=False, signals=signals)
    storage = "bfloat16" if cfg.dtype == "bfloat16" else "float32"
    kw = dict(storage_dtype=storage, num_workers=cfg.num_workers,
              device=device)
    if cfg.task == "detection":
        t_out, kind = 0, "detection"
        _, plain, _ = load_dataset_detection(
            max_seq_len=cfg.max_seq_len, sampling_ratio=cfg.sampling_ratio,
            seed=123, **plain_common)
        build = lambda ds: build_detection_cache(ds, cfg.max_seq_len, **kw)
    elif cfg.task == "classification":
        t_out, kind = 0, "classification"
        _, plain, _ = load_dataset_classification(
            max_seq_len=cfg.max_seq_len, padding_val=0.0, **plain_common)
        build = lambda ds: build_classification_cache(ds, cfg.max_seq_len,
                                                      **kw)
    else:  # SS pre-training
        t_out, kind = cfg.output_seq_len, "ssl"
        _, plain, _ = load_dataset_ssl(
            input_len=cfg.max_seq_len, output_len=cfg.output_seq_len,
            **plain_common)
        build = lambda ds: build_ssl_cache(ds, cfg.max_seq_len, **kw)

    budget = int(cfg.hbm_budget_gb * 2 ** 30)
    n_total = sum(len(ds) for ds in plain.values())
    if fits_in_hbm(n_total, cfg.max_seq_len, cfg.num_nodes, cfg.input_dim,
                   storage, t_out=t_out, budget_bytes=budget):
        return pipeline, {s: build(ds) for s, ds in plain.items()}
    caches = {s: build_rotating_cache(ds, cfg.max_seq_len, kind,
                                      budget_bytes=budget, **kw)
              for s, ds in plain.items()}
    print("hbm_cache: split exceeds the HBM budget; using the chunked "
          f"rotating cache ({caches['train'].num_shards} shards, "
          "double-buffered H2D)", file=sys.stderr)
    return pipeline, caches


def main(argv=None, *, device=None, signals=None):
    """Parse ``argv`` (the process's arguments by default), train and
    evaluate; returns the test results.

    ``signals``: resampled signals by h5 path, for a corpus held in memory
    (``data/synthetic.make_synthetic_corpus(signals=...)``) on hosts
    without h5py.
    """
    from eeg_gnn_tpu_torch.config import ExperimentConfig, build_parser
    from eeg_gnn_tpu_torch.data.datasets import (
        load_dataset_classification,
        load_dataset_densecnn_classification,
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
                sampling_ratio=cfg.sampling_ratio, seed=123,
                raw_mode=cfg.raw_clips, **common)
        elif cfg.task == "classification" and cfg.model_name == "densecnn":
            # the reference's flat-clip loader (train.py:92-106)
            loaders, _, scaler = load_dataset_densecnn_classification(
                input_dir=cfg.input_dir, raw_data_dir=cfg.raw_data_dir,
                train_batch_size=cfg.train_batch_size,
                test_batch_size=cfg.test_batch_size,
                max_seq_len=cfg.max_seq_len, standardize=True,
                num_workers=cfg.num_workers, padding_val=0.0,
                augmentation=cfg.data_augment, use_fft=cfg.use_fft,
                preproc_dir=cfg.preproc_dir, marker_dir=marker_dir,
                signals=signals)
        elif cfg.task == "classification":
            loaders, _, scaler = load_dataset_classification(
                max_seq_len=cfg.max_seq_len, padding_val=0.0, **common)
        else:  # SS pre-training
            loaders, _, scaler = load_dataset_ssl(
                input_len=cfg.max_seq_len, output_len=cfg.output_seq_len,
                raw_mode=cfg.raw_clips, **common)
        pipeline, caches = input_path(
            cfg, scaler, adj_mat_dir=adj_mat_dir, marker_dir=marker_dir,
            signals=signals, device=device)
        results = run_experiment(cfg, loaders, scaler, save_dir, log, tbx,
                                 device=device, input_pipeline=pipeline,
                                 device_caches=caches)
    finally:
        tbx.close()
    with open(os.path.join(save_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
