"""Device idle ms a batch while the host is in ``Embedder``'s ``pad`` span
(bucket and row padding, peak normalisation), from the traced stretch
(``device_trace``, ``spans.split``). Moves ``embed_clips_per_s``."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run, ("pad",))
