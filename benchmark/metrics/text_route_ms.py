"""Device ms a batch of the records launched in the DeepSeek-V2 tower's
``moe_route`` span (the router product, softmax, top-k, the sort of the (token, choice) rows by expert and their gather, every MoE layer), from the traced stretch
(``device_trace``, ``spans.split``). Moves ``embed_clips_per_s``."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, ("moe_route",))
