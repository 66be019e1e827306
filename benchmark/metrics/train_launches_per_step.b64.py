"""Device kernels a step of the device-bound train cell launches: the
kernel records of the traced stretch ÷ its steps (``device_trace``).
Moves ``train_clips_per_s.b64``: each launch of its own is device work
that a fused kernel would merge."""

from benchmark import readers


def read(run):
    return readers.launches_per_step(run)
