"""The device's idle share of the traced stretch: 1 − the union of its
device records' intervals ÷ the stretch's length (``device_trace``), in
%. Moves ``train_clips_per_s``."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run)
