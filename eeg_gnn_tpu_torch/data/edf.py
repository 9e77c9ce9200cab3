"""Pure-numpy EDF/EDF+ reader and writer (``eeg_gnn_tpu/data/edf.py``,
copied as it is: its arithmetic is part of the result).

Replaces the reference's pyedflib dependency (a C extension used only for
offline ingest, reference ``data/resample_signals.py:30`` and
``data_utils.py:139-155``). The EDF format is a fixed ASCII header plus
int16 little-endian sample records, so a vectorized numpy decode is both
simpler and faster than per-channel C calls for whole-file reads.

Format reference: EDF specification (Kemp et al.), public domain layout:
256-byte fixed header, then 256 bytes per signal of field arrays, then
data records of interleaved int16 samples.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class EDFHeader:
    version: str
    patient_id: str
    recording_id: str
    start_date: str
    start_time: str
    header_bytes: int
    num_records: int
    record_duration: float
    num_signals: int
    labels: List[str]
    physical_min: np.ndarray
    physical_max: np.ndarray
    digital_min: np.ndarray
    digital_max: np.ndarray
    samples_per_record: np.ndarray

    def sample_frequencies(self) -> np.ndarray:
        return self.samples_per_record / self.record_duration


def _ascii(b: bytes) -> str:
    return b.decode("ascii", errors="replace").strip()


def read_edf_header(path: str) -> EDFHeader:
    with open(path, "rb") as f:
        fixed = f.read(256)
        version = _ascii(fixed[0:8])
        patient = _ascii(fixed[8:88])
        recording = _ascii(fixed[88:168])
        start_date = _ascii(fixed[168:176])
        start_time = _ascii(fixed[176:184])
        header_bytes = int(_ascii(fixed[184:192]))
        num_records = int(_ascii(fixed[236:244]))
        record_duration = float(_ascii(fixed[244:252]))
        ns = int(_ascii(fixed[252:256]))

        def field(width):
            raw = f.read(width * ns)
            return [
                _ascii(raw[i * width:(i + 1) * width]) for i in range(ns)
            ]

        labels = field(16)
        field(80)  # transducer
        field(8)   # physical dimension
        phys_min = np.array([float(x) for x in field(8)])
        phys_max = np.array([float(x) for x in field(8)])
        dig_min = np.array([float(x) for x in field(8)])
        dig_max = np.array([float(x) for x in field(8)])
        field(80)  # prefiltering
        spr = np.array([int(x) for x in field(8)])
        field(32)  # reserved

    return EDFHeader(version, patient, recording, start_date, start_time,
                     header_bytes, num_records, record_duration, ns, labels,
                     phys_min, phys_max, dig_min, dig_max, spr)


def read_edf_signals(path: str, header: EDFHeader | None = None) -> np.ndarray:
    """Read all signals as physical values.

    Returns (num_signals, max_samples) float64 — channels with fewer samples
    per record than the max are zero-padded at the tail, matching the
    reference's zero-initialized signal matrix (data_utils.py:139-155, which
    pads to ``getNSamples()[0]`` and leaves failed channels at zero).
    """
    h = header or read_edf_header(path)
    spr = h.samples_per_record
    rec_len = int(spr.sum())
    with open(path, "rb") as f:
        f.seek(h.header_bytes)
        raw = np.fromfile(f, dtype="<i2", count=h.num_records * rec_len)
    n_rec = raw.size // rec_len
    raw = raw[: n_rec * rec_len].reshape(n_rec, rec_len)

    # physical = (digital - dig_min) * gain + phys_min
    denom = np.where(h.digital_max - h.digital_min == 0, 1.0,
                     h.digital_max - h.digital_min)
    gain = (h.physical_max - h.physical_min) / denom

    max_samples = int(spr.max()) * n_rec
    out = np.zeros((h.num_signals, max_samples))
    offsets = np.concatenate([[0], np.cumsum(spr)]).astype(int)
    for i in range(h.num_signals):
        sig = raw[:, offsets[i]:offsets[i + 1]].reshape(-1).astype(np.float64)
        phys = (sig - h.digital_min[i]) * gain[i] + h.physical_min[i]
        out[i, : phys.size] = phys
    return out


def write_edf(path: str, signals: np.ndarray, labels: List[str],
              sample_rate: float, record_duration: float = 1.0):
    """Minimal EDF writer (test fixtures + dataset tooling)."""
    signals = np.asarray(signals)
    ns, total = signals.shape
    spr = int(sample_rate * record_duration)
    n_rec = total // spr
    # The header stores physical min/max as 8-char ASCII; pad the range
    # outward past the 4-sig-fig formatting error and quantize against the
    # values as they will be *parsed back*, so the roundtrip is exact up to
    # int16 resolution (clipping catches any residual edge case).
    lo, hi = signals.min(axis=1), signals.max(axis=1)
    pad_amt = np.maximum(hi - lo, np.maximum(np.abs(lo), np.abs(hi))) * 2e-3 + 1e-9
    phys_min = np.array([float(f"{v:.4g}") for v in lo - pad_amt])
    phys_max = np.array([float(f"{v:.4g}") for v in hi + pad_amt])
    span = np.where(phys_max - phys_min == 0, 1.0, phys_max - phys_min)
    dig_min, dig_max = -32768.0, 32767.0

    def pad(s, w):
        b = str(s).encode("ascii")[:w]
        return b + b" " * (w - len(b))

    header_bytes = 256 + 256 * ns
    with open(path, "wb") as f:
        f.write(pad("0", 8))
        f.write(pad("X X X X", 80))
        f.write(pad("Startdate X X X X", 80))
        f.write(pad("01.01.00", 8))
        f.write(pad("00.00.00", 8))
        f.write(pad(header_bytes, 8))
        f.write(pad("EDF+C", 44))
        f.write(pad(n_rec, 8))
        f.write(pad(record_duration, 8))
        f.write(pad(ns, 4))
        for lab in labels:
            f.write(pad(lab, 16))
        for _ in range(ns):
            f.write(pad("", 80))
        for _ in range(ns):
            f.write(pad("uV", 8))
        for v in phys_min:
            f.write(pad(f"{v:.4g}", 8))
        for v in phys_max:
            f.write(pad(f"{v:.4g}", 8))
        for _ in range(ns):
            f.write(pad(int(dig_min), 8))
        for _ in range(ns):
            f.write(pad(int(dig_max), 8))
        for _ in range(ns):
            f.write(pad("", 80))
        for _ in range(ns):
            f.write(pad(spr, 8))
        for _ in range(ns):
            f.write(pad("", 32))

        digital = (
            (signals[:, : n_rec * spr] - phys_min[:, None]) / span[:, None]
            * (dig_max - dig_min) + dig_min
        )
        digital = np.clip(np.round(digital), dig_min, dig_max).astype("<i2")
        # interleave per record: for each record, all signals' chunks
        rec = digital.reshape(ns, n_rec, spr).transpose(1, 0, 2)
        rec.tofile(f)


def get_ordered_channels(file_name: str, labels: List[str],
                         channel_names: List[str], verbose: bool = False):
    """Map wanted channel names to signal indices; raises if any missing.

    Parity: reference ``getOrderedChannels`` (data_utils.py:66-79) —
    labels are compared after stripping the '-REF' style suffix.
    """
    stripped = [l.split("-")[0] for l in labels]
    ordered = []
    for ch in channel_names:
        try:
            ordered.append(stripped.index(ch))
        except ValueError:
            if verbose:
                print(f"{file_name} failed to get channel {ch}")
            raise Exception("channel not match")
    return ordered
