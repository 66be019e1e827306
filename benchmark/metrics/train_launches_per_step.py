"""Device kernels a train step launches: the kernel records of the traced
stretch ÷ its steps (``device_trace``). Moves ``train_clips_per_s``: in the
host-bound step each launch costs the autograd thread its dispatch."""

from benchmark import readers


def read(run):
    return readers.launches_per_step(run)
