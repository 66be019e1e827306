"""Device ms a batch of the records launched in the DeepSeek-V2 tower's
``text_attention`` span (the MLA products, the latent norm, rope, attention and the output product of every layer), from the traced stretch
(``device_trace``, ``spans.split``). Moves ``embed_clips_per_s``."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, ("text_attention",))
