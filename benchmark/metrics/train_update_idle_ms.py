"""Device idle ms a step while the host is in the update: the train step's
``grad_norm`` and ``optimizer`` spans (AdamW as tensor code), from the
traced stretch (``device_trace``, ``spans.split``). Moves
``train_clips_per_s``."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run, spans.UPDATE)
