"""Device ms a batch of the records launched in the DeepSeek-V2 tower's
``moe_experts`` span (the routed experts' grouped products and the weighted combine, every MoE layer), from the traced stretch
(``device_trace``, ``spans.split``). Moves ``embed_clips_per_s``."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, ("moe_experts",))
