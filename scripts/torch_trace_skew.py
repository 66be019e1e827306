#!/usr/bin/env python
"""How far ``torch.profiler``'s device records stand from their launches on
the host clock, and how many it keeps, with and without the padded window
of ``utils.bench.device_trace``.

    python scripts/torch_trace_skew.py [--traces 20] [--iters 20]

The profiler keeps a device record only where its times fall inside the
window on the host clock. Each trace launches ``--iters`` small
elementwise kernels on one stream, back to back, and pairs the i-th
kernel record with the i-th host launch. Per trace it reads the kernels
recorded and the offset of each record's start from its launch; the
windows are opened with no pad and with ``TRACE_PAD_S``. Prints the
card's name and power limit, then one JSON line with each setting's
kernels recorded (min, max) and offsets in µs (min, median, max).
Needs a card.
"""

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from speech_transcript_embeddings_torch.inference.embed import (  # noqa: E402
    resolve_device,
)
from speech_transcript_embeddings_torch.utils import bench as ub  # noqa: E402


def one_trace(fn, iters):
    """(kernels recorded, [record start − launch start, µs])."""
    with ub.device_trace() as prof:
        for _ in range(iters):
            fn()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e.time_range.start for e in events
                      if e.device_type == cuda), key=float)
    launched = sorted((e.time_range.start for e in events
                       if e.device_type != cuda and "aunch" in e.name),
                      key=float)
    return len(kernels), [k - h for k, h in zip(kernels, launched)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traces", type=int, default=20)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    resolve_device("cuda")
    print(ub.card_line(), flush=True)
    x = torch.randn(1 << 16, device="cuda")
    fn = lambda: x.mul(2.0)  # noqa: E731
    for _ in range(3):
        fn()
    pad = ub.TRACE_PAD_S
    out = {"iters": args.iters, "traces": args.traces}
    for name, seconds in (("no_pad", 0.0), ("padded", pad)):
        ub.TRACE_PAD_S = seconds
        runs = [one_trace(fn, args.iters) for _ in range(args.traces)]
        counts = [n for n, _ in runs]
        offsets = [o for _, off in runs for o in off]
        out[name] = {"pad_s": seconds, "recorded": [min(counts), max(counts)],
                     "offset_us": [min(offsets), statistics.median(offsets),
                                   max(offsets)]}
    ub.TRACE_PAD_S = pad
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
