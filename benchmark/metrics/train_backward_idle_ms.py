"""Device idle ms a step while the host is in the train step's
``backward`` span (``torch.autograd.grad``: the calling thread waits while
the autograd engine's thread dispatches), from the traced stretch
(``device_trace``, ``spans.split``). Moves ``train_clips_per_s``."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run, ("backward",))
