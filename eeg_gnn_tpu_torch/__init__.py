"""eeg_gnn_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of
``eeg_gnn_tpu``, built beside it slice by slice.

The JAX package is the reference; this package imports neither JAX nor
anything of ``eeg_gnn_tpu``. Parameter names and layouts stay the
reference's, so a JAX ``.npz`` checkpoint maps onto a port ``state_dict``
key for key (``io/jax_params.py``).

Slices 1-3 (this package today) serve and train DCRNN seizure
detection and classification, and run SSL next-window pre-training:

- ``constants`` / ``config``  — the fields the model, ``Predictor`` and
                  the train step read.
- ``graphs``    — spectral supports (host numpy oracles + batched torch).
- ``ops``       — Chebyshev diffusion, the operator-stacked recurrence with
                  its hand-written BPTT, and the CUDA kernels (``csrc/``)
                  of the DCGRU encoder recurrence and of the seq2seq
                  decoder, forward and backward, with their plain PyTorch
                  versions and autograd Functions.
- ``models``    — DCGRU encoder and decoder, ``DCRNNClassifier``,
                  ``DCRNNNextTimePred`` and the registry.
- ``io``        — JAX parameter trees and ``.npz`` checkpoints.
- ``serve``     — the fixed-shape batched ``Predictor``.
- ``train``     — losses (BCE, CE, masked regression), clip + Adam +
                  cosine LR, and ``TrainStep`` (supervised and SSL).

What is still to port is listed in ROADMAP.md.
"""

__version__ = "0.1.0"
