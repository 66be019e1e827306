"""Device idle ms a step while the host is in the train step's ``forward``
span (``forward_pos_neg``), from the traced stretch (``device_trace``,
``spans.split``). Moves ``train_clips_per_s``: in the host-bound step the
card waits on the forward's dispatch."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run, ("forward",))
