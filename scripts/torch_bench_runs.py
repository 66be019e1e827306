#!/usr/bin/env python
"""Run the port's benchmark tools on the card in rounds, and summarise.

    python scripts/torch_bench_runs.py [--rounds 3] [--only NAME ...]
        [--out chiprun_out/bench_runs.jsonl]
    python scripts/torch_bench_runs.py --summary [--out FILE]

Each round runs, one process at a time: ``bench_torch.py`` with each of
its four configs, ``scripts/torch_infer_bench.py`` in bf16 and with
``--int8``; ``scripts/torch_mfu.py`` runs once, after the last round. The
last JSON line of each run is appended to ``--out`` with the run's name
and round (a failed run's return code and the end of its errors
instead, and this script exits non-zero after the rest have run); each
run's whole output goes beside it, ``<out stem>_<name>_<round>.log``.
``--summary`` prints the median and range of each run's readings over
its rounds as a Markdown table, with the clock, power and card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {
    "retrieval": ["bench_torch.py"],
    "retrieval-lengths": ["bench_torch.py", "--config", "retrieval-lengths"],
    "retrieval-frozen": ["bench_torch.py", "--config", "retrieval-frozen"],
    "flagship-pairwise": ["bench_torch.py", "--config", "flagship-pairwise"],
    "embed-bf16": ["scripts/torch_infer_bench.py"],
    "embed-int8": ["scripts/torch_infer_bench.py", "--int8"],
}
MFU = ["scripts/torch_mfu.py"]


def run(name, cmd, rnd, out):
    log = f"{os.path.splitext(out)[0]}_{name}_{rnd}.log"
    proc = subprocess.run([sys.executable, *cmd], cwd=ROOT,
                          capture_output=True, text=True, timeout=1800)
    with open(log, "w") as f:
        f.write(proc.stdout + proc.stderr)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode or not lines:
        recs = [{"rc": proc.returncode, "stderr": proc.stderr[-3000:]}]
    else:
        # torch_mfu.py prints a line per measurement
        recs = [json.loads(ln) for ln in (lines if cmd == MFU
                                          else lines[-1:])]
    with open(out, "a") as f:
        for r in recs:
            f.write(json.dumps(dict(r, run=name, round=rnd)) + "\n")
    print(f"{name} round {rnd}: rc {proc.returncode}", flush=True)
    return proc.returncode == 0


def _stat(values, fmt):
    values = [v for v in values if v is not None]
    if not values:
        return "not measured"
    med = statistics.median(values)
    if len(values) == 1:
        return fmt.format(med)
    return (fmt.format(med) + " (" + fmt.format(min(values)) + "–"
            + fmt.format(max(values)) + ")")


def _readings(rec):
    """(name, reading) of one JSON line: its headline, and for
    ``retrieval`` the fixed 10 s step beside it; each reading with the
    keys of the summary's columns."""
    name = rec.get("what") if rec["run"] == "mfu" else rec["run"]
    tflop = next(rec[k] for k in ("step_tflop", "executed_tflops",
                                  "model_tflops") if k in rec)
    ratio = rec.get("hfu", rec.get("mfu"))
    clips = next((rec[k] for k in ("value", "clips_per_s", "clips_per_sec")
                  if k in rec), None)
    out = [(name, dict(rec, clips=clips, tflop=tflop, ratio=ratio,
                       step=rec.get("step_ms", rec.get("ms"))))]
    fixed = rec.get("fixed_10s")
    if fixed:
        out.append((f"{name}, fixed 10 s", dict(
            rec, **fixed, clips=rec["fixed_10s_value"],
            tflop=fixed["step_tflop"], ratio=fixed["hfu"],
            step=fixed["step_ms"])))
    return out


def summary(out):
    """A Markdown table: each reading, median (min–max) over its runs."""
    by_name, failed = {}, {}
    with open(out) as f:
        for ln in f:
            rec = json.loads(ln)
            if "rc" in rec:
                failed[rec["run"]] = failed.get(rec["run"], 0) + 1
                continue
            for name, r in _readings(rec):
                by_name.setdefault(name, []).append(r)
    rows = ["| Reading | n | clips/s | step ms | device busy ms | idle | "
            "TFLOP a step | HFU / MFU | peak GiB | SM MHz | W | card |",
            "|" + " --- |" * 12]
    for name, rs in by_name.items():
        g = lambda k: [r.get(k) for r in rs]                 # noqa: E731
        med = lambda k: [(r.get(k) or {}).get("median")       # noqa: E731
                         for r in rs]
        rows.append(
            f"| {name} | {len(rs)} | {_stat(g('clips'), '{:.2f}')} | "
            f"{_stat(g('step'), '{:.1f}')} | "
            f"{_stat(g('device_busy_ms'), '{:.1f}')} | "
            f"{_stat(g('idle_share'), '{:.0%}')} | "
            f"{_stat(g('tflop'), '{:.2f}')} | {_stat(g('ratio'), '{:.1%}')} "
            f"| {_stat(g('peak_memory_gib'), '{:.2f}')} | "
            f"{_stat(med('sm_clock_mhz'), '{:.0f}')} | "
            f"{_stat(med('power_w'), '{:.0f}')} | {rs[0].get('card')} |")
    for name, n in failed.items():
        rows.append(f"| {name} | {n} failed |" + " |" * 10)
    print("\n".join(rows))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", nargs="*", choices=[*RUNS, "mfu"])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "bench_runs.jsonl"))
    ap.add_argument("--summary", action="store_true")
    args = ap.parse_args(argv)
    if not args.summary:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        names = args.only or [*RUNS, "mfu"]
        ok = True
        for rnd in range(1, args.rounds + 1):
            for name in names:
                if name in RUNS:
                    ok &= run(name, RUNS[name], rnd, args.out)
        if "mfu" in names:
            ok &= run("mfu", MFU, 1, args.out)
    summary(args.out)
    if not args.summary and not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
