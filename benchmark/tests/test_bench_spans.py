"""The phase split of a traced stretch (``benchmark/spans.py``) and the
readers that read it, on hand-made traces in the style of
``test_bench_result._events``: each phase's idle, launches and device µs;
a gap across two ranges split between them; the phases and ``outside``
adding up to the union's gaps; the autograd engine's launches counted as
the backward's; a trace without ranges reading None."""

import importlib.util
import json
import os

import pytest

from benchmark import common, run, spans, trace
from benchmark.tests import tiny

NEW = {"train_forward_idle_ms": "retrieval-train-cvmix",
       "train_backward_idle_ms": "retrieval-train-cvmix",
       "train_update_idle_ms": "retrieval-train-cvmix",
       "train_update_launches": "retrieval-train-cvmix",
       "train_update_ms.b64": "flagship-train-b64",
       "embed_pad_idle_ms": "flagship-embed-cvmix",
       "embed_h2d_idle_ms": "flagship-embed-cvmix"}


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2, tid, corr)


def _device(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


def _events(backward_span=True):
    """µs. The calling thread (1) opens ``forward`` (0-100), ``backward``
    (100-200: it waits while the engine's thread 2 launches), ``optimizer``
    (200-300) with ``grad_norm`` nested in it (220-240), and launches one
    kernel after them all; the engine launches one kernel under an
    autograd node. The device runs kernels (and a memset) at 20-40,
    70-120, 130-140, 230-235, 260-270, 275-280, 320-330: gaps 40-70
    (forward 30), 120-130 (backward 10), 140-230 (backward 60, optimizer
    20, grad_norm 10), 235-260 (grad_norm 5, optimizer 20), 270-275
    (optimizer 5), 280-320 (optimizer 20, outside 20)."""
    host = [
        _x("user_annotation", "phase: forward", 0, 100),
        _x("cpu_op", "aten::linear", 10, 20), _launch(12, 1),
        _x("cpu_op", "aten::mul", 55, 15), _launch(60, 2),
        _x("user_annotation", "phase: optimizer", 200, 100),
        _x("user_annotation", "phase: grad_norm", 220, 20),
        _x("cpu_op", "aten::linalg_vector_norm", 222, 8), _launch(225, 4),
        _x("cpu_op", "aten::add_", 245, 10), _launch(250, 5),
        _x("cpu_op", "aten::copy_", 305, 10), _launch(310, 6),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
           110, 40, tid=2),
        _x("cpu_op", "aten::mm", 115, 10, tid=2), _launch(120, 3, tid=2),
    ]
    if backward_span:
        host.append(_x("user_annotation", "phase: backward", 100, 100))
    device = [
        _device("kernel", "gemm_a", 20, 20, 1),
        _device("kernel", "elementwise_kernel", 70, 50, 2),
        _device("kernel", "gemm_b", 130, 10, 3),
        _device("kernel", "reduce_kernel", 230, 5, 4),
        _device("kernel", "multi_tensor_apply", 260, 10, 5),
        _device("gpu_memset", "Memset (Device)", 275, 5, 5),
        _device("kernel", "copy_kernel", 320, 10, 6),
        # the device side of a range: not a host range, not a record
        {"ph": "X", "cat": "gpu_user_annotation", "name": "phase: forward",
         "ts": 20, "dur": 100, "pid": 0, "tid": 7},
    ]
    return host + device


class Run:
    def __init__(self, events, steps=2):
        self.stretch = {"events": events, "steps": steps}


def test_each_phase_reads_its_idle_launches_and_device_us():
    got = spans.split(_events())
    assert got["idle_us"] == {"forward": 30, "backward": 70,
                              "optimizer": 65, "grad_norm": 15,
                              "outside": 20}
    # the memset is a device record of the optimizer, not a kernel
    assert got["launches"] == {"forward": 2, "backward": 1, "grad_norm": 1,
                               "optimizer": 1, "outside": 1}
    assert got["device_us"] == {"forward": 70, "backward": 10,
                                "grad_norm": 5, "optimizer": 15,
                                "outside": 10}


def test_a_gap_across_two_spans_is_split_between_them():
    events = [_x("user_annotation", "phase: pad", 0, 50),
              _x("user_annotation", "phase: h2d", 50, 50),
              _device("kernel", "k", -10, 20, 1),
              _device("kernel", "k", 90, 30, 2)]
    assert spans.split(events)["idle_us"] == {"pad": 40, "h2d": 40,
                                              "outside": 0}


@pytest.mark.parametrize("backward_span", [True, False])
def test_phases_and_outside_add_up_to_the_union(backward_span):
    events = _events(backward_span)
    got = spans.split(events)
    device = sorted((e for e in events if e["cat"] in trace.DEVICE_CATS),
                    key=lambda e: e["ts"])
    _, gaps = trace._union(device)
    assert sum(got["idle_us"].values()) == sum(b - a for a, b, _ in gaps)
    assert sum(got["launches"].values()) == len(
        trace.summarize(events)["kernels"])
    assert sum(got["device_us"].values()) == sum(e["dur"] for e in device)


def test_engine_thread_launches_count_as_backward():
    """Without the calling thread's ``backward`` range the engine's launch
    is still the backward's; the idle it spanned falls to the ranges
    around it and to ``outside``."""
    got = spans.split(_events(backward_span=False))
    assert got["launches"]["backward"] == 1
    assert got["device_us"]["backward"] == 10
    assert "backward" not in got["idle_us"]
    assert got["idle_us"]["outside"] == 20 + 70


def _metric(name):
    path = os.path.join(common.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(
        ".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_readers_divide_by_the_steps():
    r = Run(_events(), steps=2)
    got = {name: _metric(name).read(r) for name in NEW}
    assert got == pytest.approx({"train_forward_idle_ms": 0.015,
                                 "train_backward_idle_ms": 0.035,
                                 "train_update_idle_ms": 0.040,
                                 "train_update_launches": 1.0,
                                 "train_update_ms.b64": 0.010,
                                 "embed_pad_idle_ms": 0.0,
                                 "embed_h2d_idle_ms": 0.0})


def test_a_trace_without_spans_reads_none():
    from benchmark.tests.test_bench_result import _events as plain
    assert spans.split(plain()) is None
    for name in NEW:
        assert _metric(name).read(Run(plain())) is None


@pytest.mark.parametrize("with_spans", [True, False])
def test_result_line_reports_the_cells_new_metrics(with_spans):
    """Each cell's line holds its new metrics where the trace has ranges,
    and leaves them out (as the parent's program reads) where it has
    none."""
    from benchmark.tests.test_bench_result import _events as plain
    events = _events() if with_spans else plain()
    for cell_name in sorted(set(NEW.values())):
        cell = common.find_cell(cell_name)
        out = {"attempted": 1, "failed": 0, "end_to_end": {},
               "readings": {k: 0.0 for k in cell.limits},
               "memory_peak_bytes": 1,
               "window": {"seconds": 1.0, "steps": 1, "clips": 1,
                          "model_flops": 1e9},
               "stretch": {"window_s": 1.0, "steps": 2, "attention": [],
                           "events": events}}
        ctx = tiny.CpuContext(trace=True)
        line = json.loads(json.dumps(run.assemble(
            cell, ctx, out, {"memory_peak_bytes": 1}, 989e12, 3.35e12)))
        mine = {n for n, c in NEW.items() if c == cell_name}
        if with_spans:
            assert mine <= set(line["metrics"])
        else:
            assert not mine & set(line["metrics"])
