"""The on-device input pipeline (``eeg_gnn_tpu/data/device_pipeline.py``).

The reference featurizes per sample on the host in DataLoader workers:
FFT per 1 s window, augmentation, standardization, 171 xcorr pairs and
the supports. Here the host only reads and slices raw clips; the rest
runs on the device the pipeline was built for, inside the train step or
the ``Predictor`` call:

    raw (B, C, L) --> windows/FFT --> reflect+scale augment --> z-score
                   -> correlation Gram -> top-k -> random-walk supports
                      (or per-clip choice of the two distance-graph
                       support variants under reflection)

Parity notes (tests/test_torch_device_pipeline.py holds each against the
JAX pipeline):

- augmentation order as the reference: augment THEN standardize, both in
  the features' dtype (bf16 for a bf16 dataset cache); the scale is an
  additive log under FFT (dataloader_detection.py:233-256);
- the correlation graph is built from the float32 upcast of the
  UN-augmented features (the reference's dead-code quirk, graphs/xcorr.py);
- the distance graph under reflection uses the reference's swapped
  adjacency, precomputed on the host as a second support slab;
- the augmentation draws, ``(reflect, scale)`` per clip, come from an
  explicit ``torch.Generator`` on the device (``DevicePipeline.draw``).
  JAX draws them from its step key: the two are equal in distribution,
  not bit for bit. The math that applies given draws is separate, so a
  caller (the tests) can feed the JAX key's draws and compare exactly.

- classification's padded clips (``classification_features``): the host
  pads after augment and standardize (dataloader_classification.py:
  334-352), so the tail re-pins rows t >= seq_len to the padding value
  afterwards, and the correlation graph is built from the length-masked
  clip, which equals the host's unpadded whole-clip correlation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from eeg_gnn_tpu_torch.constants import FREQUENCY, get_swap_pairs
from eeg_gnn_tpu_torch.device import resolve_device
from eeg_gnn_tpu_torch.graphs.distance import (
    load_distance_adjacency,
    swap_adjacency_nodes,
)
from eeg_gnn_tpu_torch.graphs.supports import (
    compute_supports,
    compute_supports_torch,
)
from eeg_gnn_tpu_torch.graphs.xcorr import correlation_adjacency_torch
from eeg_gnn_tpu_torch.ops.fft_features import featurize_clip
from eeg_gnn_tpu_torch.parallel.mesh import rand
from eeg_gnn_tpu_torch.utils.profiling import count, span, timed

Draws = Tuple[torch.Tensor, torch.Tensor]


def reflection_permutation(num_nodes: int) -> np.ndarray:
    """Node permutation realizing the left-right electrode reflection."""
    perm = np.arange(num_nodes)
    for a, b in get_swap_pairs():
        perm[a], perm[b] = perm[b], perm[a]
    return perm


def _in_dtype(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (the JAX pipeline casts its scalars to
    the features' dtype before the arithmetic)."""
    return float(torch.tensor(v, dtype=dtype))


@dataclasses.dataclass(frozen=True)
class DevicePipeline:
    """The featurizer of :func:`make_device_pipeline`; its tensors live on
    one device, and every input must too.

    ``reflect_invariant``: with the combined graph, reflect neither the
    clip nor the graph, and keep ONE shared (S, N, N) support slab.
    Reflecting both (x' = Px, A' = PAPᵀ) is a relabeling of the nodes, to
    which the DCRNN family (per-node shared weights, a node-symmetric
    head and loss) is invariant: at dropout 0 the loss and gradients are
    exactly the unreflected ones. The reference's swapped adjacency is
    not a true permutation (graphs/distance.py), so this deviates from
    the literal reference at those entries; it is opt-in
    (DIVERGENCES.md, "Reflection-invariant supports"). Correlation
    graphs are built from the unreflected clip and never take it.
    """

    time_step_size: int
    use_fft: bool
    graph_type: str            # 'individual' | 'combined'
    filter_type: str
    top_k: Optional[int]
    mean: float
    std: float
    augment: bool
    node_perm: torch.Tensor                           # (N,) int64
    dist_supports: Optional[torch.Tensor]             # (S, N, N) or None
    dist_supports_swapped: Optional[torch.Tensor]     # (S, N, N) or None
    reflect_invariant: bool = False

    @property
    def device(self) -> torch.device:
        return self.node_perm.device

    def draw(self, batch: int, generator: torch.Generator) -> Draws:
        """The augmentation draws of ``batch`` clips from ``generator``:
        (reflect (B,) bool with p=0.5, scale (B,) float32 uniform in
        [0.8, 1.2)), one launch on the generator's device (the global
        batch's under a data-parallel step, ``parallel.mesh.rand``)."""
        u = rand((2, batch), generator, generator.device, batch_axis=1)
        return u[0] < 0.5, 0.8 + 0.4 * u[1]

    def _augmenting(self, training: bool) -> Tuple[bool, bool]:
        """(augment, reflect) for this call."""
        do_aug = self.augment and training
        combined = self.graph_type != "individual"
        return do_aug, do_aug and not (combined and self.reflect_invariant)

    def _augment(self, feats: torch.Tensor, reflect: torch.Tensor,
                 scale: torch.Tensor, do_reflect: bool) -> torch.Tensor:
        out = feats
        if do_reflect:
            out = torch.where(reflect[:, None, None, None],
                              feats[:, :, self.node_perm, :], feats)
        if self.use_fft:
            return out + scale.log().to(feats.dtype)[:, None, None, None]
        return out * scale.to(feats.dtype)[:, None, None, None]

    def _standardize(self, f: torch.Tensor) -> torch.Tensor:
        return (f - _in_dtype(self.mean, f.dtype)) / _in_dtype(self.std,
                                                              f.dtype)

    def _supports(self, graph_feats: torch.Tensor, reflect, do_reflect):
        if self.graph_type == "individual":
            # graph from the UN-augmented features, in float32 (top-k
            # tie-breaks want full precision under bf16 storage)
            with span("eeg.step.graph"):
                count("eeg.step.graph_clips", graph_feats.shape[0])
                adj = correlation_adjacency_torch(graph_feats.float(),
                                                  top_k=self.top_k)
                return compute_supports_torch(adj, self.filter_type)
        if do_reflect:
            return torch.where(reflect[None, :, None, None],
                               self.dist_supports_swapped[:, None],
                               self.dist_supports[:, None])  # (S, B, N, N)
        return self.dist_supports  # shared (S, N, N) slab

    def _draws(self, batch, generator, draws) -> Draws:
        if draws is None:
            if generator is None:
                raise ValueError("augmenting needs a generator or draws")
            return self.draw(batch, generator)
        return draws

    def __call__(self, raw: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 training: bool = False, draws: Optional[Draws] = None):
        """raw (B, C, L) -> (x (B, T, C, D), supports (S, B, N, N) or the
        shared (S, N, N))."""
        feats = featurize_clip(raw, self.time_step_size, FREQUENCY,
                               self.use_fft)
        return self.features(feats, generator, training, draws)

    def features(self, feats: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 training: bool = False, draws: Optional[Draws] = None,
                 graph_feats: Optional[torch.Tensor] = None):
        """The tail after featurization: augment -> standardize ->
        supports, for already-featurized (B, T, C, D) clips (what the
        dataset caches hold). ``draws`` overrides the generator's
        (reflect, scale); ``graph_feats`` the tensor the correlation graph
        is built from."""
        do_aug, do_reflect = self._augmenting(training)
        reflect = None
        aug = feats
        if do_aug:
            reflect, scale = self._draws(feats.shape[0], generator, draws)
            aug = self._augment(feats, reflect, scale, do_reflect)
        x = self._standardize(aug)
        gfeats = feats if graph_feats is None else graph_feats
        return x, self._supports(gfeats, reflect, do_reflect)

    def classification_features(self, feats: torch.Tensor,
                                seq_lengths: torch.Tensor,
                                generator: Optional[torch.Generator] = None,
                                training: bool = False,
                                draws: Optional[Draws] = None,
                                padding_val: float = 0.0):
        """The classification tail for padded (B, T, C, D) clips of true
        lengths ``seq_lengths`` (B,) (what the classification caches hold):
        :meth:`features`, then rows t >= seq_len re-pinned to
        ``padding_val``, so the padding takes neither the augmentation's
        scale nor the z-score. The individual graph is built from the clip
        with those rows zeroed: zero rows add nothing to the Gram's dot
        products or the channels' energies, so it equals the host's
        correlation of the unpadded clip for every length, whatever the
        cache padded with."""
        rows = (torch.arange(feats.shape[1], device=feats.device)[None, :]
                < seq_lengths[:, None])[:, :, None, None]  # (B, T, 1, 1)
        graph_feats = None
        if self.graph_type == "individual":
            graph_feats = torch.where(rows, feats, feats.new_zeros(()))
        x, supports = self.features(feats, generator, training, draws,
                                    graph_feats=graph_feats)
        return torch.where(rows, x, x.new_full((), padding_val)), supports

    def ssl(self, raw_x: torch.Tensor, raw_y: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            training: bool = False, draws: Optional[Draws] = None):
        """SSL pairs: (raw_x (B, C, Lx), raw_y (B, C, Ly)) -> (x, y,
        supports)."""
        fx = featurize_clip(raw_x, self.time_step_size, FREQUENCY,
                            self.use_fft)
        fy = featurize_clip(raw_y, self.time_step_size, FREQUENCY,
                            self.use_fft)
        return self.ssl_features(fx, fy, generator, training, draws)

    def ssl_features(self, fx: torch.Tensor, fy: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     training: bool = False,
                     draws: Optional[Draws] = None):
        """The SSL tail for already-featurized x/y pairs: one reflect
        decision and scale factor apply to both clips; the graph comes
        from the un-augmented x (dataloader_ssl.py:315-349)."""
        do_aug, do_reflect = self._augmenting(training)
        reflect = None
        ax, ay = fx, fy
        if do_aug:
            reflect, scale = self._draws(fx.shape[0], generator, draws)
            ax = self._augment(fx, reflect, scale, do_reflect)
            ay = self._augment(fy, reflect, scale, do_reflect)
        return (self._standardize(ax), self._standardize(ay),
                self._supports(fx, reflect, do_reflect))


@timed("eeg.setup.pipeline")
def make_device_pipeline(*, graph_type: str, filter_type: str,
                         top_k: Optional[int], use_fft: bool,
                         time_step_size: int, scaler, augment: bool,
                         adj_mat_dir: Optional[str] = None,
                         num_nodes: int = 19,
                         reflect_invariant: bool = False,
                         device=None) -> DevicePipeline:
    """The pipeline on ``device`` (``None``: the CUDA card, raising without
    one; e.g. ``"cpu"``): the reflection permutation and, for the combined
    graph, the distance graph's supports and its swapped variant's,
    built once on the host (float64, λmax by ``eigvalsh``) and held there
    as float32 tensors. ``reflect_invariant``: see
    :class:`DevicePipeline`."""
    dev = resolve_device(device, "make_device_pipeline")
    dist_sup = dist_sup_sw = None
    if graph_type == "combined":
        adj = load_distance_adjacency(adj_mat_dir)
        slab = lambda a: torch.from_numpy(
            np.stack(compute_supports(a, filter_type))).to(dev)
        dist_sup = slab(adj)
        dist_sup_sw = slab(swap_adjacency_nodes(adj, get_swap_pairs()))
    return DevicePipeline(
        time_step_size=time_step_size,
        use_fft=use_fft,
        graph_type=graph_type,
        filter_type=filter_type,
        top_k=top_k,
        mean=float(scaler.mean) if scaler is not None else 0.0,
        std=float(scaler.std) if scaler is not None else 1.0,
        augment=augment,
        node_perm=torch.from_numpy(reflection_permutation(num_nodes)).to(dev),
        dist_supports=dist_sup,
        dist_supports_swapped=dist_sup_sw,
        reflect_invariant=reflect_invariant,
    )
