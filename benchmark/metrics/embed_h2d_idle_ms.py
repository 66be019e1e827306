"""Device idle ms a batch while the host is in ``Embedder``'s ``h2d`` span
(the padded batch's copy to the card), from the traced stretch
(``device_trace``, ``spans.split``). Moves ``embed_clips_per_s``."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run, ("h2d",))
