"""The benchmark's plain reference against the port's CPU path, at a tiny
size: supports, the detector's and the SSL model's forward,
the losses, and three training steps' readings."""

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.reference import dcrnn as ref
from portbench.reference import train as ref_train

from eeg_gnn_tpu_torch.graphs.supports import compute_supports
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.train.losses import compute_regression_loss

from portbench.drivers.common import program_config

SMALL = {"task": "detection", "model_name": "dcrnn", "graph_type": "combined",
         "max_seq_len": 4, "output_seq_len": 3, "time_step_size": 1,
         "num_nodes": 19, "input_dim": 6, "output_dim": 6,
         "num_rnn_layers": 2, "rnn_units": 8, "max_diffusion_step": 2,
         "num_classes": 1, "dropout": 0.0, "use_fft": True,
         "data_augment": False, "lr_init": 1e-3, "l2_wd": 5e-4,
         "max_grad_norm": 5.0, "num_epochs": 10, "train_batch_size": 5,
         "use_curriculum_learning": True, "cl_decay_steps": 3000,
         "dtype": "float32", "feature_mean": 2.357, "feature_std": 0.65,
         "graph_seed": 3}


def _adj():
    return inputs.distance_adjacency(SMALL)


def test_supports_match_the_program():
    adj = _adj()
    for filt in ("laplacian", "dual_random_walk"):
        want = np.stack(compute_supports(adj, filt))
        np.testing.assert_allclose(ref.supports(adj, filt), want,
                                   rtol=1e-6, atol=1e-6)


def _program_model(cfg, params):
    model = build_model(program_config(cfg))
    model.load_state_dict(params)
    return model


@pytest.mark.parametrize("layers", [1, 2])
def test_detector_matches_the_program(layers):
    cfg = dict(SMALL, num_rnn_layers=layers)
    params = inputs.make_params(cfg, 7, "cpu")
    x = torch.randn(5, 4, 19, 6, generator=torch.Generator().manual_seed(1))
    sup = torch.from_numpy(ref.supports(_adj(), "laplacian"))
    model = _program_model(cfg, params).eval()
    with torch.no_grad():
        want = model(x, torch.full((5,), 4), sup).reshape(-1)
        got = ref.detector_logits(params, sup, x, layers, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_ssl_forward_and_loss_match_the_program():
    cfg = dict(SMALL, task="SS pre-training", num_rnn_layers=3)
    params = inputs.make_params(cfg, 8, "cpu")
    g = torch.Generator().manual_seed(2)
    x = torch.randn(5, 4, 19, 6, generator=g)
    y = torch.randn(5, 3, 19, 6, generator=g)
    sup = torch.from_numpy(ref.supports(_adj(), "laplacian"))
    model = _program_model(dict(cfg), params)
    seen = 24000
    with torch.no_grad():
        want = model(x, y, sup, batches_seen=seen,
                     generator=torch.Generator().manual_seed(5))
        ratio = ref_train.sampling_ratio(3000, seen)
        force = (torch.rand(3, generator=torch.Generator().manual_seed(5))
                 < ratio).tolist()
        got = ref.ssl_predictions(params, sup, x, y, force, 3, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    want_loss = compute_regression_loss(y, want, mean=torch.tensor(2.357),
                                        std=torch.tensor(0.65),
                                        loss_fn="MAE")
    torch.testing.assert_close(ref.masked_rmse(got, y, 2.357, 0.65),
                               want_loss, rtol=1e-5, atol=1e-7)


def test_bce_matches_the_program():
    from eeg_gnn_tpu_torch.train.losses import bce_with_logits

    g = torch.Generator().manual_seed(3)
    logits = torch.randn(9, generator=g) * 4
    labels = (torch.rand(9, generator=g) < 0.5).float()
    torch.testing.assert_close(ref.bce(logits, labels),
                               bce_with_logits(logits, labels))


def test_three_steps_match_the_program():
    """The reference's step (clip, L2, Adam, cosine LR) against the
    program's TrainStep fed the same batches."""
    from eeg_gnn_tpu_torch.train.step import TrainStep

    cfg = dict(SMALL, max_grad_norm=0.05)  # small: the clip engages
    params = inputs.make_params(cfg, 9, "cpu")
    adj = _adj()
    sup = torch.from_numpy(ref.supports(adj, "laplacian"))
    g = torch.Generator().manual_seed(4)
    batches = [{"x": torch.randn(5, 4, 19, 6, generator=g),
                "y": (torch.rand(5, generator=g) < 0.5).float()}
               for _ in range(3)]
    step = TrainStep(program_config(cfg), _program_model(cfg, params),
                     steps_per_epoch=2, device="cpu")
    losses = [float(step({"x": b["x"], "y": b["y"],
                          "supports": sup[:, None].expand(1, 5, 19, 19)}))
              for b in batches]
    got = ref_train.train_readings(cfg, params, sup, batches, 2)
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
    for name, p in step.model.named_parameters():
        change = float((p.detach() - params[name]).norm())
        assert abs(change - got["change"][name]) <= 1e-4 * max(
            got["change"][name], 1e-6), name


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -2.5 - 2 ** -9])
    got = ref.tf32_round(x)
    want = torch.tensor([1.0, 1.0, 1.0 + 2 ** -9, -2.5 - 2 ** -9])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
