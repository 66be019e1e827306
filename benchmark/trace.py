"""Reading a ``torch.profiler`` trace of a stretch of a run: the device
records, the union of their intervals (busy), the idle gaps, and each gap
tied to the host op that launched the kernel ending it.

``FAMILIES``, ``kernel_family``, ``host_name``, ``_union`` and
``_host_sweep`` are frozen copies of
``speech_transcript_embeddings_torch/utils/profile.py`` (the trace arithmetic
of the program's step-diagnosis tools), so that a later change to the
program cannot move the yardstick. ``TRACE_PAD_S`` and the padded window
are ``utils/bench.device_trace``'s.
"""

from __future__ import annotations

import collections
import json
import os
import re
import time
from typing import Dict, List, Optional, Sequence

# device records that occupy the card, by the trace's category
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host records a kernel can be launched from, and those that enclose them
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation") + LAUNCH_CATS
# idle gaps longer than this are listed (all gaps count in the idle time)
GAP_US = 20.0
# the ranges the program's tools open: a train step (``ProfilerStep#i``) and
# a phase of the step; the outermost op of a launch is the outermost range
# or op below them
STEP_MARK = "ProfilerStep#"
PHASE_MARK = "phase: "

# kernel name → family: the first pattern that matches (``re.search``, case
# ignored but for K1-K4), built from the names a card's trace prints
FAMILIES = (
    ("K1 log-mel normalise", r"log_mel_normalize_kernel"),
    ("K2 log-mel", r"log_mel_fft_kernel"),
    ("K3 flash forward", r"flash_rel_fwd_(wgmma_)?kernel"),
    ("K4 flash backward", r"flash_rel_bwd_(dq|dkv)"),
    ("NCCL", r"(?i)nccl"),
    ("int8 GEMM (_int_mm)", r"(?i)(gemm_s8|s8s8|imma|int8)"),
    ("depthwise convolution",
     r"(?i)(depthwise|dgrad|wgrad|fprop|implicit_gemm|cudnn|conv[12]d)"),
    ("GEMM (cuBLAS, cuBLASLt)",
     r"(?i)(gemm|gemv|nvjet|cutlass|xmma|cublas|splitkreduce|dot_kernel)"),
    ("embedding gather/scatter",
     r"(?i)(indexselect|embedding|index_elementwise|gather|scatter|"
     r"indexing_backward|radixsort|compute_grad_weight|sum_and_scatter|"
     r"krn_partial|segment_offsets|partials_per_segment|index_put|"
     r"compute_num_of_partial)"),
    ("copy/transpose/cat/memcpy",
     r"(?i)(^memcpy|^memset|copy_kernel|direct_copy|catarraybatchedcopy|"
     r"transpose|copy_device_to_device)"),
    ("reduction (softmax, LayerNorm, sums)",
     r"(?i)(reduce|softmax|layer_norm|layernorm|gammabeta|rowwisemoments|"
     r"internalgradients|lpnorm|norm_kernel|cub::|scan_innermost|"
     r"scan_outer)"),
    ("elementwise",
     r"(?i)(elementwise|multi_tensor_apply|distribution|dropout|fill|"
     r"philox)"),
)
_FAMILY_RE = tuple((f, re.compile(p)) for f, p in FAMILIES)
MISC = "misc"


def kernel_family(name: str) -> str:
    """The family of a device record's name (``FAMILIES``; else misc)."""
    for family, pattern in _FAMILY_RE:
        if pattern.search(name):
            return family
    return MISC


def host_name(name: str) -> str:
    """A host op's name with its step and layer numbers folded
    (``ProfilerStep#3`` → ``ProfilerStep#*``, ``layer_12`` → ``layer_*``),
    so that the same op of every step and layer adds up."""
    return re.sub(r"layer_\d+", "layer_*", re.sub(r"#\d+", "#*", name))


# ---- reading a trace --------------------------------------------------------

def _union(device: List[dict]):
    """→ (busy µs, the gaps [(start, end, the event that ends it)])."""
    busy, gaps = 0.0, []
    cur_start = cur_end = None
    for e in device:
        start, end = e["ts"], e["ts"] + e["dur"]
        if cur_end is None:
            cur_start, cur_end = start, end
        elif start > cur_end:
            busy += cur_end - cur_start
            gaps.append((cur_end, start, e))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy, gaps


def _host_sweep(host: List[dict]):
    """JAX's stack rule over each thread's host events: → (self time by
    folded name, {correlation id: (phase, outermost op, innermost CPU op)}
    of every launch). A launch outside every phase range under an
    autograd node (the autograd engine's own thread) is in ``backward``."""
    self_time: Dict[str, float] = collections.defaultdict(float)
    launched: Dict[int, tuple] = {}
    folded: Dict[str, str] = {}

    def fold(name):
        if name not in folded:
            folded[name] = host_name(name)
        return folded[name]

    by_thread: Dict[tuple, List[dict]] = collections.defaultdict(list)
    for e in host:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for events in by_thread.values():
        events.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[dict] = []
        for e in events:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            name = fold(e["name"])
            if stack:
                self_time[fold(stack[-1]["name"])] -= e["dur"]
            self_time[name] += e["dur"]
            corr = e.get("args", {}).get("correlation")
            if e["cat"] in LAUNCH_CATS and corr is not None:
                phases = [s["name"] for s in stack
                          if s["name"].startswith(PHASE_MARK)]
                ops = [s["name"] for s in stack if s["cat"] not in LAUNCH_CATS
                       and not s["name"].startswith((STEP_MARK, PHASE_MARK))]
                cpu = [s["name"] for s in stack if s["cat"] == "cpu_op"]
                outer = fold(ops[0]) if ops else None
                phase = (phases[-1][len(PHASE_MARK):] if phases else
                         "backward" if outer and outer.startswith(
                             "autograd::engine") else None)
                launched[corr] = (phase, outer,
                                  fold(cpu[-1]) if cpu else None)
            stack.append(e)
    return self_time, launched



# torch.profiler keeps only the device records whose times fall inside its
# window on the host clock, and a record can stand milliseconds off its
# launch: the window is padded by this much on both sides
TRACE_PAD_S = 0.05
POINTWISE = ("elementwise", "copy/transpose/cat/memcpy",
             "reduction (softmax, LayerNorm, sums)")
TOP = 10


class Stretch:
    """A traced stretch of a run: ``with Stretch(torch, path) as s:`` runs
    the work under ``torch.profiler`` (CPU and CUDA), padded, and ends with
    the device synchronised; then ``s.window_s`` is the stretch's length on
    the host clock (pads excluded) and ``s.events`` the trace's complete
    events. The trace file (``path``) is deleted once read."""

    def __init__(self, torch, path: str):
        self.torch, self.path = torch, path
        self.events: List[dict] = []
        self.window_s = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        time.sleep(TRACE_PAD_S)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        time.sleep(TRACE_PAD_S)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(self.path)
            try:
                with open(self.path) as f:
                    self.events = [e for e in json.load(f)["traceEvents"]
                                   if e.get("ph") == "X"]
            finally:
                os.unlink(self.path)


def summarize(events: Sequence[dict]) -> dict:
    """→ ``kernels`` (the device kernel records: name, ts, dur in µs),
    ``busy_us`` (the union of every device record's interval),
    ``family_us`` (device µs by ``kernel_family``), ``top_ops`` ([(name,
    seconds)] of the kernels that took most), ``idle_gaps`` ([(outermost
    host op, seconds)] of the gaps over ``GAP_US`` by the op whose launch
    ended them)."""
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                    key=lambda e: e["ts"])
    host = [e for e in events if e.get("cat") in HOST_CATS]
    _, launched = _host_sweep(host)
    busy, gaps = _union(device)
    by_kernel: Dict[str, float] = collections.defaultdict(float)
    family: Dict[str, float] = collections.defaultdict(float)
    for e in device:
        by_kernel[e["name"]] += e["dur"]
        family[kernel_family(e["name"])] += e["dur"]
    by_op: Dict[str, float] = collections.defaultdict(float)
    for start, end, e in gaps:
        if end - start <= GAP_US:
            continue
        names = launched.get(e.get("args", {}).get("correlation"),
                             (None, None, None))
        by_op[names[1] or names[2] or "(none)"] += end - start
    rank = lambda d: [[k, v / 1e6] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"kernels": [e for e in device if e.get("cat") == "kernel"],
            "busy_us": busy, "family_us": dict(family),
            "top_ops": rank(by_kernel), "idle_gaps": rank(by_op)}


def kernel_us(summary: dict, pattern: str) -> Optional[float]:
    """Device µs of the kernels whose name ``pattern`` matches (None when
    none ran)."""
    rx = re.compile(pattern)
    hits = [e["dur"] for e in summary["kernels"] if rx.search(e["name"])]
    return sum(hits) if hits else None
