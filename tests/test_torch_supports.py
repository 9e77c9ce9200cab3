"""The port's spectral supports (eeg_gnn_tpu_torch/graphs/supports.py)
against the JAX package's: host numpy oracles and the batched device
twins, for all three filter types."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eeg_gnn_tpu.graphs.supports import compute_supports as jax_host
from eeg_gnn_tpu.graphs.supports import compute_supports_jnp
from eeg_gnn_tpu_torch.graphs.supports import (
    compute_supports,
    compute_supports_torch,
    num_supports_for,
)

FILTERS = ("laplacian", "random_walk", "dual_random_walk")
N = 19


def _adjacency(rng, b, symmetric=True):
    adj = np.abs(rng.rand(b, N, N)).astype(np.float32)
    if symmetric:
        adj = (adj + adj.transpose(0, 2, 1)) / 2
    for a in adj:
        np.fill_diagonal(a, 1.0)
    return adj


@pytest.mark.parametrize("filter_type", FILTERS)
def test_host_oracle_matches_jax(rng, filter_type):
    adj = _adjacency(rng, 1, symmetric=False)[0]
    ours = compute_supports(adj, filter_type)
    ref = jax_host(adj, filter_type)
    assert len(ours) == len(ref) == num_supports_for(filter_type)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("filter_type", FILTERS)
@pytest.mark.parametrize("symmetric", [True, False])
def test_batched_torch_matches_jnp(rng, filter_type, symmetric):
    adj = _adjacency(rng, 5, symmetric)
    ours = compute_supports_torch(torch.from_numpy(adj), filter_type)
    ref = np.asarray(compute_supports_jnp(jnp.asarray(adj), filter_type))
    assert ours.shape == ref.shape == (num_supports_for(filter_type), 5, N, N)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("filter_type", FILTERS)
def test_batched_torch_matches_host_oracle(rng, filter_type):
    adj = _adjacency(rng, 3)
    ours = compute_supports_torch(torch.from_numpy(adj), filter_type).numpy()
    for b in range(3):
        for s, host in enumerate(compute_supports(adj[b], filter_type)):
            np.testing.assert_allclose(ours[s, b], host, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("filter_type", FILTERS)
def test_zero_adjacency_rows_stay_finite(filter_type):
    """A zero-padded clip (the Predictor's last chunk) has zero degrees:
    the d > 0 masking must give finite supports equal to the JAX ones."""
    adj = np.zeros((2, N, N), np.float32)
    ours = compute_supports_torch(torch.from_numpy(adj), filter_type)
    ref = np.asarray(compute_supports_jnp(jnp.asarray(adj), filter_type))
    assert torch.isfinite(ours).all()
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)
