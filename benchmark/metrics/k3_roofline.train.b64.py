"""K3, the relative_key flash forward, in the device-bound train cell: the
bound time of the stretch's forward attention calls (``roofline.py``,
valid frames) ÷ the device time of the kernels ``readers.K3`` names
(``device_trace``), in %. Moves ``train_clips_per_s.b64``."""

from benchmark import readers


def read(run):
    return readers.roofline_pct(run, readers.K3, backward=False)
