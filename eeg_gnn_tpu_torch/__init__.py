"""eeg_gnn_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of
``eeg_gnn_tpu``, built beside it slice by slice.

The JAX package is the reference; this package imports neither JAX nor
anything of ``eeg_gnn_tpu``. Parameter names and layouts stay the
reference's, so a JAX ``.npz`` checkpoint maps onto a port ``state_dict``
key for key (``io/jax_params.py``).

Slices 1 and 2 (this package today) serve and train DCRNN seizure
detection and classification:

- ``constants`` / ``config``  — the fields the model, ``Predictor`` and
                  the train step read.
- ``graphs``    — spectral supports (host numpy oracles + batched torch).
- ``ops``       — Chebyshev diffusion, the operator-stacked recurrence with
                  its hand-written BPTT, and the DCGRU recurrence CUDA
                  kernels, forward and backward (``csrc/``), with their
                  plain PyTorch versions and autograd Functions.
- ``models``    — DCGRU encoder, ``DCRNNClassifier`` and the registry.
- ``io``        — JAX parameter trees and ``.npz`` checkpoints.
- ``serve``     — the fixed-shape batched ``Predictor``.
- ``train``     — losses, clip + Adam + cosine LR, and ``TrainStep``.

What is still to port is listed in ROADMAP.md.
"""

__version__ = "0.1.0"
