"""The port's EDF codec (``eeg_gnn_tpu_torch/data/edf.py``) against the JAX
package's on the CPU, on seeded numpy signals: the header and the
physical signals read from files that either writer produced, and from a
hand-built file with mixed samples per record and a channel whose digital
range is empty (which ``write_edf`` cannot write); the writer's bytes;
channel ordering and its refusal. Everything bitwise: the two codecs are
the same numpy arithmetic."""

import dataclasses

import numpy as np
import pytest

from eeg_gnn_tpu.constants import INCLUDED_CHANNELS
from eeg_gnn_tpu.data import edf as jedf
from eeg_gnn_tpu_torch.data import edf as tedf

EXTRA = ["EEG A1-REF", "EKG1-REF", "EEG A2-REF", "PHOTIC-REF"]


def _labels(rng):
    """TUSZ-style labels with 4 channels outside the montage, shuffled."""
    labels = [ch + "-REF" for ch in INCLUDED_CHANNELS] + EXTRA
    return [labels[i] for i in rng.permutation(len(labels))]


def _assert_headers_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb)
            assert va.dtype == vb.dtype, f.name
        else:
            assert va == vb, f.name
    np.testing.assert_array_equal(a.sample_frequencies(),
                                  b.sample_frequencies())


def _hand_built_edf(path, rng):
    """3 signals at 8, 3 and 8 samples a 0.5 s record, 4 records; signal
    1 has dig_min == dig_max (the reader's gain divides by 1 there)."""
    spr = [8, 3, 8]
    ns, n_rec = len(spr), 4
    fields = [("EEG FP1-REF", "EEG FP2-REF", "EEG C3-REF"), ("",) * ns,
              ("uV",) * ns, ("-250.5", "0", "-1e3"), ("250.5", "10", "1e3"),
              ("-2048", "7", "-32768"), ("2047", "7", "32767"), ("",) * ns,
              [str(s) for s in spr], ("",) * ns]
    widths = (16, 80, 8, 8, 8, 8, 8, 80, 8, 32)

    def pad(s, w):
        b = str(s).encode("ascii")[:w]
        return b + b" " * (w - len(b))

    head = (pad("0", 8) + pad("patient x", 80) + pad("rec y", 80)
            + pad("02.03.04", 8) + pad("05.06.07", 8)
            + pad(256 + 256 * ns, 8) + pad("", 44) + pad(n_rec, 8)
            + pad("0.5", 8) + pad(ns, 4))
    for values, w in zip(fields, widths):
        head += b"".join(pad(v, w) for v in values)
    data = rng.randint(-2048, 2048, size=(n_rec, sum(spr))).astype("<i2")
    with open(path, "wb") as f:
        f.write(head)
        data.tofile(f)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("seconds,rate", [(12, 250), (7, 256)])
def test_reader_matches_jax(rng, tmp_path, writer, seconds, rate):
    sig = rng.randn(len(INCLUDED_CHANNELS) + len(EXTRA), seconds * rate)
    sig *= rng.uniform(5, 80, size=(sig.shape[0], 1))
    path = str(tmp_path / "r.edf")
    (tedf if writer == "port" else jedf).write_edf(path, sig, _labels(rng),
                                                   sample_rate=rate)
    th, jh = tedf.read_edf_header(path), jedf.read_edf_header(path)
    _assert_headers_equal(th, jh)
    got = tedf.read_edf_signals(path, th)
    np.testing.assert_array_equal(got, jedf.read_edf_signals(path))
    assert got.shape == sig.shape and got.dtype == np.float64
    # int16 over the padded physical range: within half a step, as written
    step = (th.physical_max - th.physical_min) / 65535
    assert np.all(np.abs(got - sig) <= step[:, None] * (0.5 + 1e-6))


def test_reader_matches_jax_on_a_hand_built_file(rng, tmp_path):
    path = str(tmp_path / "hand.edf")
    _hand_built_edf(path, rng)
    th, jh = tedf.read_edf_header(path), jedf.read_edf_header(path)
    _assert_headers_equal(th, jh)
    assert th.samples_per_record.tolist() == [8, 3, 8]
    assert th.record_duration == 0.5
    got = tedf.read_edf_signals(path)
    np.testing.assert_array_equal(got, jedf.read_edf_signals(path, jh))
    assert got.shape == (3, 32)
    assert np.all(got[1, 12:] == 0)  # 3 a record: zero padded to 8
    assert np.all(np.isfinite(got))  # the empty digital range: gain / 1


@pytest.mark.parametrize("record_duration", [1.0, 0.5])
def test_writer_bytes_match_jax(rng, tmp_path, record_duration):
    sig = rng.randn(len(INCLUDED_CHANNELS) + len(EXTRA), 250 * 9 + 37)
    sig *= np.linspace(0.01, 500, sig.shape[0])[:, None]
    sig[3] = 0.0  # a flat channel: its physical range is the padding
    labels = _labels(rng)
    tedf.write_edf(str(tmp_path / "t.edf"), sig, labels, 250,
                   record_duration)
    jedf.write_edf(str(tmp_path / "j.edf"), sig, labels, 250,
                   record_duration)
    t, j = ((tmp_path / f).read_bytes() for f in ("t.edf", "j.edf"))
    assert t == j and len(t) == 256 * (1 + sig.shape[0]) + 2 * 250 * 9 * \
        sig.shape[0]


def test_ordered_channels_match_jax(rng):
    labels = _labels(rng)
    got = tedf.get_ordered_channels("f", labels, INCLUDED_CHANNELS)
    assert got == jedf.get_ordered_channels("f", labels, INCLUDED_CHANNELS)
    assert [labels[i].split("-")[0] for i in got] == INCLUDED_CHANNELS
    missing = [lab for lab in labels if not lab.startswith("EEG O2")]
    for mod in (tedf, jedf):
        with pytest.raises(Exception, match="channel not match"):
            mod.get_ordered_channels("f", missing, INCLUDED_CHANNELS)
