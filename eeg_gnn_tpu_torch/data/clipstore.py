"""ClipStore: a flat memory-mapped clip tensor and a native multithreaded
batch gather (``eeg_gnn_tpu/data/clipstore.py``; the file format byte for
byte).

The AOT-cache answer to per-sample h5 reads (reference ``--preproc_dir``
semantics): all clips of a split live in ONE contiguous float32 file,
batches are assembled by the C++ gather in ``native/clipstore.cpp``
(GIL-free memcpy over threads, bound by host memory bandwidth), and labels
and names ride a JSON sidecar. The batches are the raw (B, 19,
clip_len * 200) windows of the on-device pipeline
(``data/device_pipeline.py``), as ``RawDetectionDataset`` yields them.

The native library is built with g++ at first use into the package's
``_build/`` (content-addressed: an edited source builds anew) and raises
with the compiler's output when it cannot be built or loaded: unlike the
JAX module, there is no numpy fallback on the path.
``ClipStore.gather_plain`` is the gather's plain version, for tests.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import subprocess
import tempfile
from typing import Mapping, Optional, Sequence

import numpy as np

_HEADER_BYTES = 64
_MAGIC = b"ECS1"

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native", "clipstore.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")


@functools.lru_cache(maxsize=None)
def load_native() -> ctypes.CDLL:
    """Build (if needed) and load the native gather; raises with g++'s
    output when it cannot be built, or with the loader's when the library
    cannot be loaded. The library's name hashes the source and the flags;
    it is written to a temporary name and renamed into place, so
    concurrent processes never load half a file."""
    digest = hashlib.sha256()
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(GXX_FLAGS).encode())
    out = os.path.join(BUILD_DIR,
                       f"libclipstore-{digest.hexdigest()[:12]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC],
                                  capture_output=True, text=True)
        except OSError as e:
            os.unlink(tmp)
            raise RuntimeError(f"cannot run g++ to build {_SRC}: {e}") from e
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed for {_SRC} (rc "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(out)
    except OSError as e:
        raise RuntimeError(f"cannot load the clip store's gather {out}: "
                           f"{e}") from e
    lib.ecs_open.restype = ctypes.c_void_p
    lib.ecs_open.argtypes = [ctypes.c_char_p]
    lib.ecs_gather.restype = ctypes.c_int
    lib.ecs_gather.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.ecs_close.restype = None
    lib.ecs_close.argtypes = [ctypes.c_void_p]
    return lib


def write_clipstore(path: str, clips: np.ndarray,
                    labels: Optional[Sequence] = None,
                    names: Optional[Sequence[str]] = None):
    """Write (num_clips, channels, samples) float32 clips + JSON sidecar."""
    clips = np.ascontiguousarray(clips, dtype=np.float32)
    n, c, s = clips.shape
    header = bytearray(_HEADER_BYTES)
    header[0:4] = _MAGIC
    header[0x08:0x10] = np.int64(n).tobytes()
    header[0x10:0x18] = np.int64(c).tobytes()
    header[0x18:0x20] = np.int64(s).tobytes()
    header[0x20:0x28] = np.int64(1).tobytes()  # dtype code f32
    with open(path, "wb") as f:
        f.write(bytes(header))
        clips.tofile(f)
    sidecar = {
        "num_clips": n, "channels": c, "samples": s,
        "labels": None if labels is None else np.asarray(labels).tolist(),
        "names": None if names is None else list(names),
    }
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f)


class ClipStore:
    """Read side: the native batch gather over the file's mapping, and a
    numpy memmap for the plain version. ``num_threads``: the gather's
    threads (0: the host's cores, at most 8)."""

    def __init__(self, path: str, num_threads: int = 0):
        self.path = path
        self.num_threads = num_threads
        self._lib = load_native()
        with open(path, "rb") as f:
            head = f.read(_HEADER_BYTES)
        if head[:4] != _MAGIC:
            raise ValueError(f"{path}: not a clip store")
        self.num_clips = int(np.frombuffer(head, np.int64, 1, 0x08)[0])
        self.channels = int(np.frombuffer(head, np.int64, 1, 0x10)[0])
        self.samples = int(np.frombuffer(head, np.int64, 1, 0x18)[0])
        handle = self._lib.ecs_open(path.encode())
        if not handle:
            raise ValueError(f"{path}: the native gather cannot map it "
                             "(unreadable or truncated)")
        self._handle = ctypes.c_void_p(handle)
        self._mmap = np.memmap(path, np.float32, "r", _HEADER_BYTES,
                               (self.num_clips, self.channels, self.samples))
        sidecar = path + ".json"
        self.labels = self.names = None
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                meta = json.load(f)
            if meta.get("labels") is not None:
                self.labels = np.asarray(meta["labels"])
            self.names = meta.get("names")

    def _out(self, n: int, out: Optional[np.ndarray]) -> np.ndarray:
        shape = (n, self.channels, self.samples)
        if out is None:
            return np.empty(shape, np.float32)
        if (out.shape != shape or out.dtype != np.float32
                or not out.flags.c_contiguous or not out.flags.writeable):
            raise ValueError(f"out must be a writeable C-contiguous float32 "
                             f"array of shape {shape}")
        return out

    def gather(self, indices, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Assemble a (len(indices), C, S) batch with the native gather;
        an index outside [0, num_clips) raises IndexError."""
        if self._handle is None:
            raise ValueError(f"{self.path}: the store is closed")
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = self._out(len(idx), out)
        rc = self._lib.ecs_gather(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.num_threads,
        )
        if rc != 0:
            raise IndexError("clip index out of range")
        return out

    def gather_plain(self, indices,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
        """The gather's plain version (a numpy memmap read), for tests."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = self._out(len(idx), out)
        out[:] = self._mmap[idx]
        return out

    def __len__(self):
        return self.num_clips

    def close(self):
        if self._handle is not None:
            self._lib.ecs_close(self._handle)
            self._handle = None


class ClipStoreLoader:
    """Batch iterator over a ClipStore, Trainer-compatible (raw mode).

    Yields ``data.loader.Batch`` objects with x = raw clips (B, C, S) for
    the on-device pipeline, or featurized clips if the store holds
    features. The shuffle draws from ``np.random.RandomState(seed)`` as the
    JAX loader does, so both give the same batches.
    """

    def __init__(self, store: ClipStore, batch_size: int, shuffle: bool,
                 seq_len: int, seed: int = 0, drop_last: bool = False):
        self.store = store
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seq_len = seq_len
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.store)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        from eeg_gnn_tpu_torch.data.loader import Batch

        idx = np.arange(len(self.store))
        if self.shuffle:
            self._rng.shuffle(idx)
        labels = (self.store.labels if self.store.labels is not None
                  else np.zeros(len(idx), np.float32))
        names = self.store.names or [str(i) for i in range(len(idx))]
        for lo in range(0, len(idx), self.batch_size):
            b = idx[lo:lo + self.batch_size]
            if self.drop_last and len(b) < self.batch_size:
                return
            x = self.store.gather(b)
            yield Batch(
                x=x,
                y=np.asarray(labels)[b].astype(np.float32),
                seq_lengths=np.full((len(b),), self.seq_len, np.int32),
                supports=None,
                adj=None,
                names=[names[i] for i in b],
            )


def build_clipstore_from_detection_markers(
        out_path: str, input_dir: str, marker_dir: str, split: str,
        clip_len: int, seed: int = 123, sampling_ratio: float = 1,
        signals: Optional[Mapping] = None) -> int:
    """Materialize a raw-clip store for one detection split (balanced
    undersampling applied exactly like the online path); returns its clip
    count. ``signals``: resampled signals by h5 path, read instead of the
    h5 files (hosts without h5py)."""
    from eeg_gnn_tpu_torch.data.clips import raw_clip, read_resampled_h5
    from eeg_gnn_tpu_torch.data.markers import parse_detection_markers

    sz = os.path.join(marker_dir, f"{split}Set_seq2seq_{clip_len}s_sz.txt")
    nosz = os.path.join(marker_dir, f"{split}Set_seq2seq_{clip_len}s_nosz.txt")
    tuples = parse_detection_markers(split, sz, nosz, cv_seed=seed,
                                     scale_ratio=sampling_ratio)
    clips, labels, names = [], [], []
    for h5_fn, label in tuples:
        clip_idx = int(h5_fn.split("_")[-1].split(".h5")[0])
        h5_path = os.path.join(input_dir, h5_fn.split(".edf")[0] + ".h5")
        signal = (signals[h5_path] if signals is not None
                  else read_resampled_h5(h5_path))
        clips.append(raw_clip(signal, clip_idx, clip_len))
        labels.append(float(label != 0))
        names.append(h5_fn.split(".h5")[0])
    write_clipstore(out_path, np.stack(clips), labels, names)
    return len(clips)
