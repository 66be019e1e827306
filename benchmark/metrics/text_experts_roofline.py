"""The DeepSeek-V2 tower's routed experts in bulk text embedding: the bound
time of the traced batches' routed expert products (``roofline_moe.py`` at
the rows each MoE layer's counter gives) ÷ the device time of the
``moe_experts`` span (``device_trace``, ``spans.split``; the span also
holds the weighted combine), in %. Moves ``embed_clips_per_s``."""

from benchmark import roofline_moe, spans


def read(run):
    rows = run.stretch.get("expert_rows")
    ms = spans.device_ms(run, ("moe_experts",))
    if not rows or not ms:
        return None
    t = run.config["model"]["text"]
    bound = sum(roofline_moe.experts_bound_s(
        layer, t["hidden_size"], t["moe_intermediate_size"], run.peak_flops,
        run.peak_bytes) for batch in rows for layer in batch)
    return 100.0 * bound / len(rows) / (ms / 1e3)
