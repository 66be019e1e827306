"""Device ms a step of the records launched in the update (the
``grad_norm`` and ``optimizer`` spans) in the device-bound train cell,
from the traced stretch (``device_trace``, ``spans.split``). Moves
``train_clips_per_s.b64``."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, spans.UPDATE)
