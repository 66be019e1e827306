"""K3, the relative_key flash forward, in bulk embedding: the bound time of
the stretch's attention calls (``roofline.py``, valid frames) ÷ the device
time of the kernels ``readers.K3`` names (``device_trace``), in %. Moves
``embed_clips_per_s``."""

from benchmark import readers


def read(run):
    return readers.roofline_pct(run, readers.K3, backward=False)
