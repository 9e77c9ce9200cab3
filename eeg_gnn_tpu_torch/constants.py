"""Dataset constants for the TUH/TUSZ EEG corpus (the subset the port uses).

Parity: reference ``constants.py:1-28`` — 19 standard 10-20 electrodes.
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
