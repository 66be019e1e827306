"""K4, the relative_key flash backward, in the train step: the bound time
of the stretch's backward attention calls (``roofline.py``, valid frames)
÷ the device time of the kernels ``readers.K4`` names (``device_trace``),
in %. Moves ``train_clips_per_s``."""

from benchmark import readers


def read(run):
    return readers.roofline_pct(run, readers.K4, backward=True)
