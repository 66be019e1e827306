"""Attribution of a ``torch.profiler`` trace of train steps, and the chained
timing of one module: the parts of the port's step-diagnosis tools
(``scripts/torch_profile_b16.py``, ``scripts/torch_block_breakdown.py`` and
the others), as ``scripts/profile_b16.py``'s ``_family`` and
``parse_xplane`` and ``scripts/block_breakdown.py``'s ``chained_times`` are
JAX's.

``attribute`` reads the trace's events, as a live profiler's
``export_chrome_trace`` writes them and ``load_trace`` reads them back,
never ``key_averages()``:

* **device**: each kernel's time (memcpy and memset records too), their
  sum, the union of their intervals (busy), the overlap (sum − union:
  kernels of two streams at once; the stand-in for JAX's overlapped async
  DMA), the span (first start to last end), by ``kernel_family`` and the
  top kernels;
* **host**: the self time of each host op (CPU ops, ``record_function``
  ranges and the CUDA runtime and driver calls), by JAX's stack rule: an
  event's time minus its children's on the same thread;
* **idle gaps**: each gap in the busy union, attributed to the host op
  that launched the kernel that ends it, through the launch's correlation
  id (a device record's time can stand hundreds of µs off its launch on
  the host clock, so time overlap would misattribute): the outermost op
  (a module range or an autograd node) and the innermost (``aten::…``),
  summed by name over the gaps longer than ``GAP_US``.

``span`` is the program's own mark: ``training/train_step.py`` and
``inference/embed.py`` open a ``phase: <name>`` range around each phase of
a train step and of an embedding call while a profiler records, so every
trace of them (the tools', ``train.profile_dir``'s, the benchmark's) names
the phase each launch and each idle gap falls in.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import json
import re
import statistics
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

# device records that occupy the card, by the trace's category
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host records a kernel can be launched from, and those that enclose them
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation") + LAUNCH_CATS
# idle gaps longer than this are listed (all gaps count in the idle time),
# by each name a launch carries
GAP_US = 20.0
GAP_SIDES = ("phase", "outermost_op", "innermost_op")
# ms a step of the device, None in a trace without device records
DEVICE_KEYS = ("device_ms_per_step", "device_busy_ms_per_step",
               "overlap_ms_per_step", "async_dma_ms_per_step_overlapped",
               "span_ms_per_step", "device_busy_fraction_of_span",
               "idle_ms_per_step", "idle_gaps_over_ms_per_step",
               "idle_attributed_share")
TOP = 20
# the ranges of a trace: a train step (``ProfilerStep#i``, the tools'), a
# phase (``span``, the program's) and a module (``module_ranges``, the
# tools'). The outermost op of a launch is the outermost range or op below
# the step and the phase.
STEP_MARK = "ProfilerStep#"
PHASE_MARK = "phase: "
MODULE_MARK = "module: "

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


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range ``phase: <name>`` while a profiler
    records; else a shared no-op context, so that a span off costs one
    flag check."""
    if torch._C._autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(PHASE_MARK + name)
    return _NO_SPAN


# ---- reading a trace --------------------------------------------------------

def load_trace(path: str) -> List[dict]:
    """The ``traceEvents`` of a Chrome trace (``.json`` or ``.json.gz``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


@contextlib.contextmanager
def call_ranges(targets: Dict[str, Sequence[tuple]]):
    """A ``record_function`` range named ``<name>`` around every call of
    each ``(owner, attribute)`` listed under it in ``targets`` (a module's
    function, or an object's method); the attributes are put back after.
    """
    saved = []
    for name, calls in targets.items():
        for owner, attr in calls:
            fn = getattr(owner, attr)

            def wrapped(*args, fn=fn, name=name, **kwargs):
                with torch.autograd.profiler.record_function(name):
                    return fn(*args, **kwargs)

            saved.append((owner, attr, attr in vars(owner),
                          vars(owner).get(attr)))
            setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        for owner, attr, had, old in reversed(saved):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)


@contextlib.contextmanager
def module_ranges(named: Dict[str, torch.nn.Module]):
    """A ``record_function`` range named ``module: <name>`` around every
    forward call of each module of ``named`` (its remat replays too), so
    that a trace's host ops carry the module they ran in. Pass modules
    that do not contain one another. The closing hook runs on an exception
    too: a non-reentrant checkpoint's replay stops a forward by raising
    once it has what the backward needs. A conformer block calls its
    attention through ``project`` and ``attend``, not its forward: those
    two calls get the range instead."""
    from speech_transcript_embeddings_torch.models.audio_encoder import (
        RelPositionAttention,
    )
    handles, methods = [], {}
    for name, mod in named.items():
        if isinstance(mod, RelPositionAttention):
            methods[MODULE_MARK + name] = [(mod, "project"), (mod, "attend")]
            continue
        stack = []

        def pre(_mod, _args, name=name, stack=stack):
            rf = torch.autograd.profiler.record_function(MODULE_MARK + name)
            rf.__enter__()
            stack.append(rf)

        def post(_mod, _args, _out, stack=stack):
            stack.pop().__exit__(None, None, None)

        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post, always_call=True)]
    try:
        with call_ranges(methods):
            yield
    finally:
        for h in handles:
            h.remove()


def step_modules(model: torch.nn.Module, frontend=None
                 ) -> Dict[str, torch.nn.Module]:
    """The modules ``module_ranges`` marks in a dual encoder's step: in
    each encoder, each module two names deep once the ``layer_i`` parts
    are left out (a conformer block's ``ffn1``, ``attention``, ``conv``…,
    a text layer's ``attention``, ``intermediate``…, the embeddings and
    the feature projection); each head; the frontend."""
    out = {"frontend": frontend} if frontend is not None else {}
    for name, mod in model.named_modules():
        parts = [p for p in name.split(".")
                 if not re.fullmatch(r"layer_\d+", p)]
        encoder = parts[0].endswith("_encoder")
        if name and len(parts) == (2 if encoder else 1):
            out[name] = mod
    return out


# ---- attribution ------------------------------------------------------------

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


def _rows(times: Dict[str, float], counts: Dict[str, int], total: float,
          steps: int, key: str, n: Optional[int] = None) -> List[dict]:
    ranked = sorted(times.items(), key=lambda kv: -kv[1])
    return [{key: k, "time_pct": 100.0 * t / total if total else 0.0,
             "ms_per_step": t / steps / 1e3, "count": counts[k]}
            for k, t in ranked[:n]]


def attribute(events: Iterable[dict], steps: int, top: int = TOP,
              gap_us: float = GAP_US) -> dict:
    """The attribution of a trace of ``steps`` steps (module docstring):
    ms a step; shares of the summed device time, and of the summed host
    self time. A trace without device records (a CPU run) has its device
    keys None and no families, kernels or gaps."""
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in DEVICE_CATS:
            device.append(e)
        elif e.get("cat") in HOST_CATS:
            host.append(e)
    self_time, launched = _host_sweep(host)
    host_self = {k: t for k, t in self_time.items() if t > 0}
    host_total = sum(host_self.values())
    host_n = collections.Counter()
    for name, n in collections.Counter(e["name"] for e in host).items():
        host_n[host_name(name)] += n
    out = {"host_self_ms_per_step": host_total / steps / 1e3,
           "host_top_ops": _rows(host_self, host_n, host_total, steps, "op",
                                 top)}
    out.update(_device_part(device, launched, steps, top, gap_us))
    return out


def _device_part(device: List[dict], launched: Dict[int, tuple], steps: int,
                 top: int, gap_us: float) -> dict:
    if not device:
        return {**dict.fromkeys(DEVICE_KEYS), "planes": [],
                "kernels_per_step": 0, "by_family": [], "top_ops": [],
                "all_ops": [], "idle_gap_threshold_us": gap_us,
                "idle_gaps": {f"by_{k}": [] for k in GAP_SIDES}}
    device.sort(key=lambda e: e["ts"])
    kernel_us: Dict[str, float] = collections.defaultdict(float)
    fam_us: Dict[str, float] = collections.defaultdict(float)
    kernel_n: Dict[str, int] = collections.Counter()
    fam_n: Dict[str, int] = collections.Counter()
    streams: Dict[str, int] = collections.Counter()
    for e in device:
        kernel_us[e["name"]] += e["dur"]
        kernel_n[e["name"]] += 1
        args = e.get("args", {})
        streams[f"device {args.get('device', e.get('pid'))} stream "
                f"{args.get('stream', e.get('tid'))}"] += 1
    for name, us in kernel_us.items():
        f = kernel_family(name)
        fam_us[f] += us
        fam_n[f] += kernel_n[name]
    total = sum(kernel_us.values())
    busy, gaps = _union(device)
    span = max(e["ts"] + e["dur"] for e in device) - device[0]["ts"]

    idle = attributed = long_us = 0.0
    gap_us_by = {k: collections.defaultdict(float) for k in GAP_SIDES}
    gap_n_by = {k: collections.Counter() for k in GAP_SIDES}
    for start, end, e in gaps:
        names = launched.get(e.get("args", {}).get("correlation"),
                             (None, None, None))
        idle += end - start
        if names[1] is not None:
            attributed += end - start
        if end - start <= gap_us:
            continue
        long_us += end - start
        for side, name in zip(GAP_SIDES, names):
            name = name or "(none)"
            gap_us_by[side][name] += end - start
            gap_n_by[side][name] += 1
    ms = lambda us: us / steps / 1e3
    return {
        "planes": [f"{k} ({n} records)" for k, n in sorted(streams.items())],
        "device_ms_per_step": ms(total),
        "device_busy_ms_per_step": ms(busy),
        "overlap_ms_per_step": ms(total - busy),
        "async_dma_ms_per_step_overlapped": ms(total - busy),
        "span_ms_per_step": ms(span),
        "device_busy_fraction_of_span": busy / span if span else 1.0,
        "idle_ms_per_step": ms(idle),
        "idle_gaps_over_ms_per_step": ms(long_us),
        "idle_gap_threshold_us": gap_us,
        "idle_attributed_share": attributed / idle if idle else 1.0,
        "kernels_per_step": len(device) / steps,
        "by_family": _rows(fam_us, fam_n, total, steps, "family"),
        "top_ops": _rows(kernel_us, kernel_n, total, steps, "op", top),
        "all_ops": _rows(kernel_us, kernel_n, total, steps, "op"),
        "idle_gaps": {f"by_{k}": _rows(gap_us_by[k], gap_n_by[k], long_us,
                                       steps, "op", top) for k in GAP_SIDES},
    }


# ---- chained timing ---------------------------------------------------------

def chain(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
          k: int) -> torch.Tensor:
    """``fn`` applied ``k`` times, the carry renormalised by its RMS after
    each application and cast back to ``x``'s dtype (JAX's ``scan`` body
    in ``chained_times``)."""
    c = x
    for _ in range(k):
        y = fn(c)
        y = y * torch.rsqrt(torch.mean(torch.square(y)) + 1e-6)
        c = y.to(x.dtype)
    return c


def chain_loss_grads(fn, params: Sequence[torch.Tensor], x: torch.Tensor,
                     k: int):
    """``sum(chain(fn, x, k))`` in fp32 and its gradients with respect to
    ``params`` and ``x`` (JAX's ``value_and_grad(loss, argnums=(0, 1))``).
    """
    x = x.detach().requires_grad_(True)
    loss = torch.sum(chain(fn, x, k).float())
    grads = torch.autograd.grad(loss, [*params, x])
    return loss.detach(), grads[:-1], grads[-1]


def median_call_s(fn, inputs: Sequence, sync, n: int = 12,
                  warmup: int = 3) -> float:
    """The median of ``n`` blocked calls' host times (``fn(inputs[i])``,
    then ``sync()``), after ``warmup`` calls: the median rejects the
    per-call jitter a mean of a short run cannot, and the blocking sync's
    cost is a constant that cancels in a slope."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    sync()
    ts = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(inputs[i % len(inputs)])
        sync()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def chained_times(fn, params: Sequence[torch.Tensor], x: torch.Tensor,
                  sync, k1: int = 2, k2: int = 6, inputs: int = 8):
    """Per-application forward and forward+backward seconds of ``fn``:
    the slope between chains of ``k1`` and ``k2`` applications (which
    cancels the per-call overhead), each timed by ``median_call_s`` over
    ``inputs`` distinct inputs ``x + 1e-3·noise``. The forward runs without
    gradients."""
    gen = torch.Generator(x.device).manual_seed(17)
    xs = [x + 1e-3 * torch.randn(x.shape, generator=gen, device=x.device,
                                 dtype=x.dtype) for _ in range(inputs)]

    def fwd(k):
        def run(c):
            with torch.no_grad():
                return chain(fn, c, k)
        return run

    def fwd_bwd(k):
        return lambda c: chain_loss_grads(fn, params, c, k)

    tf = (median_call_s(fwd(k2), xs, sync)
          - median_call_s(fwd(k1), xs, sync)) / (k2 - k1)
    tg = (median_call_s(fwd_bwd(k2), xs, sync)
          - median_call_s(fwd_bwd(k1), xs, sync)) / (k2 - k1)
    return tf, tg
