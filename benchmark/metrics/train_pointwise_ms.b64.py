"""Device ms a step of the device-bound train cell spends in elementwise,
copy/cast and reduction kernels (the frozen ``kernel_family`` classes),
over the traced stretch (``device_trace``). Moves
``train_clips_per_s.b64``."""

from benchmark import readers, trace


def read(run):
    return readers.family_ms_per_step(run, trace.POINTWISE)
