"""Dataset constants for the TUH/TUSZ EEG corpus.

Parity: reference ``constants.py:1-28`` (19 standard 10-20 electrodes at
200 Hz; 8 TUSZ seizure-type annotation labels).
"""

# The 19 EEG channels of interest, in canonical order. The node index of an
# electrode everywhere in this framework is its position in this list.
INCLUDED_CHANNELS = [
    "EEG FP1",
    "EEG FP2",
    "EEG F3",
    "EEG F4",
    "EEG C3",
    "EEG C4",
    "EEG P3",
    "EEG P4",
    "EEG O1",
    "EEG O2",
    "EEG F7",
    "EEG F8",
    "EEG T3",
    "EEG T4",
    "EEG T5",
    "EEG T6",
    "EEG FZ",
    "EEG CZ",
    "EEG PZ",
]

NUM_NODES = len(INCLUDED_CHANNELS)  # 19

# Target resampling frequency (Hz).
FREQUENCY = 200

# All seizure annotation labels available in TUH, mapped to class ids.
ALL_LABEL_DICT = {
    "fnsz": 0,
    "gnsz": 1,
    "spsz": 2,
    "cpsz": 3,
    "absz": 4,
    "tnsz": 5,
    "tcsz": 6,
    "mysz": 7,
}

# Left/right hemisphere electrode pairs swapped by the reflection
# augmentation (reference data/data_utils.py:37-63). Expressed as index
# pairs into INCLUDED_CHANNELS.
_SWAP_NAMES = [
    ("EEG FP1", "EEG FP2"),
    ("EEG F3", "EEG F4"),
    ("EEG F7", "EEG F8"),
    ("EEG C3", "EEG C4"),
    ("EEG T3", "EEG T4"),
    ("EEG T5", "EEG T6"),
    ("EEG O1", "EEG O2"),
]


def get_swap_pairs(channels=None):
    """Index pairs of symmetric electrodes to swap for left-right reflection.

    Parity: reference ``data/data_utils.py:37-63`` (same pairs, resolved
    against the provided channel-name list).
    """
    channels = INCLUDED_CHANNELS if channels is None else channels
    pairs = []
    for a, b in _SWAP_NAMES:
        if a in channels and b in channels:
            pairs.append((channels.index(a), channels.index(b)))
    return pairs
