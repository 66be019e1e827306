"""Kernels a step launched in the update (the ``grad_norm`` and
``optimizer`` spans), from the traced stretch (``device_trace``,
``spans.split``). Moves ``train_clips_per_s``: in the host-bound step each
launch costs the host its dispatch."""

from benchmark import spans


def read(run):
    return spans.launches(run, spans.UPDATE)
