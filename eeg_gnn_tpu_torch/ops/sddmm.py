"""SDDMM, sampled dense-dense matrix multiplication, for correlation
re-scoring of a fixed graph (``eeg_gnn_tpu/ops/sddmm.py``).

``out[e] = <x[rows[e]], y[cols[e]]>``: the entries of the dense Gram
product ``X Y^T`` at a sparse edge set, which for zero-lag 'valid'
correlation of equal-length signals is the reference's per-pair
``scipy.signal.correlate`` (``data/data_utils.py:203-222``).

- :func:`sddmm_edges`: the plain edge-list version (gather and row-wise
  dot).
- :func:`sddmm_blocksparse`: the CUDA kernel (``csrc/sddmm.cu``) that
  replaces the Pallas kernel ``_sddmm_block_kernel`` (``sddmm.py:104``):
  dense (128, 128) tiles of ``X Y^T`` at the occupied block coordinates
  only, so work scales with the occupied blocks, not with N^2. Its plain
  version is :func:`sddmm_blocksparse_plain`.
- :func:`sddmm_edges_blocksparse`: the edge-list front door over it.

The wrapper computes with the plain version when its input lies on the
CPU, launches the kernel when it lies on a CUDA device, and raises
otherwise or on what the kernel does not take (only float32); it counts
its launches in ``sddmm_blocksparse.launches``. No gradient: nothing
trains through the re-score.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from eeg_gnn_tpu_torch.graphs.xcorr import full_f32_matmul
from eeg_gnn_tpu_torch.ops import _build

_LIB = "sddmm"
_TILE = 64  # csrc kTile: block must be a multiple of it

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    lib.sddmm_blocksparse.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    lib.sddmm_blocksparse.restype = _I
    lib.sddmm_error_string.argtypes = [_I]
    lib.sddmm_error_string.restype = ctypes.c_char_p
    return lib


def _index(v, device) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.to(device, torch.int64)
    return torch.as_tensor(np.asarray(v, np.int64), device=device)


def _normalize(vals, x, y, rows, cols):
    """Divide by ``||x_r|| ||y_c||``; zero-energy rows keep the unnormalized
    value (reference ``data_utils.py:219-221`` skips the division)."""
    ex = (x * x).sum(dim=-1)
    ey = (y * y).sum(dim=-1)
    denom = torch.sqrt(ex[rows] * ey[cols])
    pos = denom > 0
    return torch.where(pos, vals / torch.where(pos, denom,
                                               torch.ones_like(denom)), vals)


def sddmm_edges(rows, cols, x, y, normalize: bool = False):
    """Edge-list SDDMM: ``out[e] = <x[rows[e]], y[cols[e]]>``.

    Args:
        rows, cols: (E,) edge endpoints (numpy or tensors).
        x, y: (N, D) dense factors.
        normalize: divide by ``||x_r|| * ||y_c||`` (not where either is 0).

    Returns:
        (E,) float32 sampled products.
    """
    rows, cols = _index(rows, x.device), _index(cols, x.device)
    vals = (x[rows].float() * y[cols].float()).sum(dim=-1)
    if normalize:
        vals = _normalize(vals, x.float(), y.float(), rows, cols)
    return vals


def edges_to_blocks(rows: np.ndarray, cols: np.ndarray, n: int,
                    block: int = 128):
    """Host-side: bucket an edge list into occupied (block_row, block_col)
    coordinates (in ``np.unique`` order) plus each edge's position inside
    its block.

    Returns:
        block_rows, block_cols: (nnzb,) int32 occupied block coordinates;
        edge_block: (E,) int32 index into them per edge;
        edge_pos: (E, 2) int32 (row, col) offset of each edge in its block.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    br, bc = rows // block, cols // block
    nb = (n + block - 1) // block
    uniq, inverse = np.unique(br * nb + bc, return_inverse=True)
    block_rows = (uniq // nb).astype(np.int32)
    block_cols = (uniq % nb).astype(np.int32)
    edge_pos = np.stack([rows % block, cols % block], axis=1).astype(np.int32)
    return block_rows, block_cols, inverse.reshape(-1).astype(np.int32), \
        edge_pos


def sddmm_blocksparse_plain(x, y, block_rows, block_cols, block: int = 128):
    """Plain version of :func:`sddmm_blocksparse`: the occupied blocks'
    row slabs gathered from zero-padded factors and multiplied with
    ``torch.matmul`` (full float32 on a card: TF32 off)."""
    n, d = x.shape
    pad = (-n) % block
    slabs = lambda v: torch.nn.functional.pad(v.float(), (0, 0, 0, pad)) \
        .view(-1, block, d)
    xb = slabs(x)[_index(block_rows, x.device)]
    yb = slabs(y)[_index(block_cols, x.device)]
    with full_f32_matmul():
        return torch.matmul(xb, yb.transpose(1, 2))


def sddmm_blocksparse(x, y, block_rows, block_cols, block: int = 128):
    """Block-sparse SDDMM through the CUDA kernel: dense (block, block)
    tiles of ``X Y^T`` at the occupied block coordinates only.

    Args:
        x, y: (N, D) float32 factors; rows past N count as zeros (the JAX
            package pads N to a block multiple and D to 128 with zeros).
        block_rows, block_cols: (nnzb,) occupied block coordinates
            (:func:`edges_to_blocks`), copied to the device as int32.
        block: the square block's edge, a multiple of 64.

    Returns:
        (nnzb, block, block) float32; gather edge values with
        ``out[edge_block, edge_pos[:, 0], edge_pos[:, 1]]``.
    """
    if x.device.type == "cpu":
        return sddmm_blocksparse_plain(x, y, block_rows, block_cols, block)
    name = "sddmm_blocksparse"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {x.device} are neither on the "
                         "CPU nor on a CUDA device")
    if x.ndim != 2 or tuple(y.shape) != tuple(x.shape):
        raise ValueError(f"{name}: takes x and y of one shape (N, D), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    for t in (x, y):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: takes float32 factors, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if block < _TILE or block % _TILE:
        raise ValueError(f"{name}: block {block} is not a multiple of "
                         f"{_TILE}")
    br = torch.as_tensor(block_rows, dtype=torch.int32,
                         device=x.device).contiguous()
    bc = torch.as_tensor(block_cols, dtype=torch.int32,
                         device=x.device).contiguous()
    if br.ndim != 1 or tuple(bc.shape) != tuple(br.shape):
        raise ValueError(f"{name}: block coordinates {tuple(br.shape)} and "
                         f"{tuple(bc.shape)} are not two (nnzb,) vectors")
    n, d = x.shape
    nnzb = br.shape[0]
    out = torch.empty((nnzb, block, block), dtype=torch.float32,
                      device=x.device)
    if nnzb == 0 or n == 0:
        return out.zero_()
    with torch.cuda.device(x.device):
        err = _lib().sddmm_blocksparse(
            x.data_ptr(), y.data_ptr(), br.data_ptr(), bc.data_ptr(),
            out.data_ptr(), n, d, nnzb, block,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = _lib().sddmm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    sddmm_blocksparse.launches += 1
    return out


sddmm_blocksparse.launches = 0


def sddmm_edges_blocksparse(rows, cols, x, y, n: int, block: int = 128,
                            normalize: bool = False):
    """Edge-list front door over :func:`sddmm_blocksparse`: the contract of
    :func:`sddmm_edges`, with the block bucketing done on the host once per
    call (``rows`` / ``cols`` are host arrays)."""
    rows, cols = np.asarray(rows), np.asarray(cols)
    block_rows, block_cols, edge_block, edge_pos = edges_to_blocks(
        rows, cols, n, block)
    blocks = sddmm_blocksparse(x, y, block_rows, block_cols, block)
    dev = x.device
    vals = blocks[_index(edge_block, dev), _index(edge_pos[:, 0], dev),
                  _index(edge_pos[:, 1], dev)]
    if normalize:
        vals = _normalize(vals, x.float(), y.float(), _index(rows, dev),
                          _index(cols, dev))
    return vals
