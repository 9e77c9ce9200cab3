"""eeg_gnn_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of
``eeg_gnn_tpu``, built beside it slice by slice.

The JAX package is the reference; this package imports neither JAX nor
anything of ``eeg_gnn_tpu``. Parameter names and layouts stay the
reference's, so a JAX ``.npz`` checkpoint maps onto a port ``state_dict``
key for key (``io/jax_params.py``).

It serves and trains DCRNN seizure detection and classification and the
LSTM, CNN-LSTM and Dense-CNN baselines, runs SSL next-window
pre-training, and runs the training CLI end to end
(``python -m eeg_gnn_tpu_torch.cli.train``):

- ``constants`` / ``config``  — the JAX package's config fields and CLI
                  flags.
- ``data``      — synthetic corpus, markers, clips, augmentation, scaler,
                  the detection, classification, Dense-CNN flat-clip and
                  SSL datasets and the threaded loader.
- ``graphs``    — spectral supports (host numpy oracles + batched torch),
                  the distance and correlation graphs.
- ``ops``       — the numpy FFT features, Chebyshev diffusion, the
                  operator-stacked recurrence with its hand-written BPTT, and the CUDA kernels (``csrc/``)
                  of the DCGRU encoder recurrence and of the seq2seq
                  decoder, forward and backward, with their plain PyTorch
                  versions and autograd Functions.
- ``models``    — DCGRU encoder and decoder, ``DCRNNClassifier``,
                  ``DCRNNNextTimePred``, the baselines ``LSTMModel``,
                  ``CNNLSTM`` and ``DenseCNN``, and the registry.
- ``io``        — JAX parameter trees, ``.npz`` checkpoints and the
                  reference's ``.pth.tar`` files.
- ``serve``     — the fixed-shape batched ``Predictor``.
- ``train``     — losses (BCE, CE, masked regression), clip + Adam +
                  cosine LR, ``TrainStep`` (supervised and SSL) and its
                  eval step, numpy metrics, checkpoints, and the
                  ``Trainer`` / ``run_experiment`` driver.
- ``cli``       — the training entry point; ``utils`` — logging and the
                  metrics sink.

What is still to port is listed in ROADMAP.md.
"""

__version__ = "0.1.0"
