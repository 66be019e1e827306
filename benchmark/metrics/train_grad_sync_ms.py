"""Device ms a step of the records launched in the train step's
``grad_sync`` span: the gradient all-reduce over the data axis (NCCL on
cards), on rank 0, from the traced stretch (``device_trace``,
``spans.split``). Moves ``train_clips_per_s``."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, ("grad_sync",))
