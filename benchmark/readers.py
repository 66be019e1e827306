"""The arithmetic the per-layer metrics' readers (``metrics/<name>.py``)
share: a kernel's share of its roofline, the device's idle share of a
traced stretch, a window's share of the bf16 peak, and the device ms a
step in some kernel families. Each returns None where the run holds
nothing to read."""

from __future__ import annotations

from typing import Optional, Sequence

from benchmark import card, roofline, trace

K3 = r"flash_rel_fwd_(wgmma_)?kernel"
K4 = r"flash_rel_bwd_(dq|dkv)"


def roofline_pct(run, pattern: str, backward: bool) -> Optional[float]:
    """The bound time of the stretch's attention calls (forward or
    backward, ``roofline.attention_bound_s`` at each clip's valid frames)
    over the device time of the kernels ``pattern`` names, in %."""
    stretch = run.stretch
    us = trace.kernel_us(stretch["summary"], pattern)
    if us is None:
        return None
    a = run.config["model"]["audio"]
    heads, hd = a["num_heads"], a["hidden_size"] // a["num_heads"]
    num_pos = a["left_max_rel_pos"] + a["right_max_rel_pos"] + 1
    bound = 0.0
    for frames, forward_calls, backward_calls in stretch["attention"]:
        calls = backward_calls if backward else forward_calls
        bound += calls * roofline.attention_bound_s(
            frames, heads, hd, num_pos, run.peak_flops, run.peak_bytes,
            backward)
    if bound == 0.0:
        return None
    return 100.0 * bound / (us / 1e6)


def idle_pct(run) -> Optional[float]:
    """1 − the union of the device records' intervals ÷ the stretch, %."""
    s = run.stretch
    if not s["summary"]["kernels"] or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["summary"]["busy_us"] / 1e6 / s["window_s"])


def mfu_pct(run) -> Optional[float]:
    """The window's model FLOPs ÷ its seconds ÷ the bf16 peak, %; a share
    above 1 raises (``card.ceiling``)."""
    w = run.window
    if not w or not w.get("model_flops"):
        return None
    return 100.0 * card.ceiling(w["model_flops"], w["seconds"],
                                run.peak_flops)


def launches_per_step(run) -> Optional[float]:
    """The kernel records of the traced stretch ÷ its steps."""
    s = run.stretch
    if not s["summary"]["kernels"] or not s["steps"]:
        return None
    return len(s["summary"]["kernels"]) / s["steps"]


def family_ms_per_step(run, families: Sequence[str]) -> Optional[float]:
    s = run.stretch
    if not s["summary"]["kernels"] or not s["steps"]:
        return None
    us = sum(s["summary"]["family_us"].get(f, 0.0) for f in families)
    return us / 1e3 / s["steps"]
