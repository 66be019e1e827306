#!/usr/bin/env python
"""The port's parity16 runs against the JAX package's committed one.

Reads the artifacts of ``runs/parity16_retained`` (JAX) and of the port's
runs A (``runs/torch_parity16_s42``), B (``_s43``), C (``_s42_kernels``)
and, where present, D-G (``_s44`` to ``_s47``), written by
``scripts/torch_parity16_runs.sh``, and prints, as markdown: the validation
gap, loss and clean/corrupt similarity of each epoch, the test gap of both
best checkpoints, Recall@1/5/10, MRR, the int8 deltas, retrieval at the
fixed epochs 6 and 8 (D-G), each run's train clips/s an epoch and the
batch-32/64/96 lines of epoch 1; then the flags of the comparison rule.
JAX has one seed, so the port's seed spread |A − B| sets the bound: a
metric is flagged when JAX lies further from A than max(2·|A − B|, floor),
and C likewise from A (the kernels must not change learning beyond the
seed spread); int8 is flagged where |ΔR@1| > 0.01 or |Δgap| > 0.005. Last,
JAX against all of the port's seeds (A, B, D-G; C repeats A's): per
metric their range, mean and standard deviation, and how many standard
deviations JAX lies from the mean. Standard library only:

    python scripts/torch_parity16_compare.py
"""

import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"JAX": "parity16_retained", "A": "torch_parity16_s42",
        "B": "torch_parity16_s43", "C": "torch_parity16_s42_kernels",
        "D": "torch_parity16_s44", "E": "torch_parity16_s45",
        "F": "torch_parity16_s46", "G": "torch_parity16_s47"}
SEEDS = ("A", "B", "D", "E", "F", "G")     # one run of each port seed
FIXED_EPOCHS = (6, 8)
FLOORS = {"val gap, epoch 8": 0.02, "test gap (best_gap)": 0.02,
          "R@1": 0.02, "MRR": 0.03}
INT8_LIMITS = {"recall@1": 0.01, "similarity_gap": 0.005}
EPOCH = re.compile(r"Epoch (\d+)/\d+ - .*Time: ([\d.]+)s \(([\d.]+) clips/s "
                   r"train(?:, ([\d.]+) after the first step)?")
VAL = re.compile(r"Epoch (\d+)/\d+ - .*Val Loss: ([\d.]+), Clean Sim: "
                 r"([\d.]+), Corrupt Sim: ([\d.]+)")
BATCH = re.compile(r"Epoch 1 batch (32|64|96): (loss=\S+ clean=\S+ "
                   r"corrupt=\S+ gap=\S+)")


def load(run):
    d = os.path.join(ROOT, "runs", run)
    with open(os.path.join(d, "proxy_summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(d, "int8_quality_eval.json")) as f:
        int8 = json.load(f)
    with open(os.path.join(d, "training.log")) as f:
        log = f.read()
    epochs = [(int(m[1]), float(m[2]), float(m[3]),
               float(m[4]) if m[4] else None) for m in EPOCH.finditer(log)]
    val = {int(m[1]): tuple(float(x) for x in m.groups()[1:])
           for m in VAL.finditer(log)}
    batches = {int(m[1]): m[2] for m in BATCH.finditer(log)}
    card = re.search(r"PyTorch port on cuda \((.*)\)", log)
    fixed = {}
    for e in FIXED_EPOCHS:
        path = os.path.join(d, f"int8_quality_eval_epoch{e}.json")
        if os.path.isfile(path):
            with open(path) as f:
                fixed[e] = json.load(f)["fp"]
    return dict(summary=summary, int8=int8, epochs=epochs, val=val,
                batches=batches, fixed=fixed,
                card=card[1] if card else "TPU (JAX)")


def metrics(r):
    s = r["summary"]
    tm, ret = s["test_metrics"], s["retrieval"]
    return {"val gap, epoch 8": s["val_gap_trajectory"][-1],
            "test gap (best_gap)": tm["best_gap_model"]["similarity_gap"],
            "test gap (best_loss)": tm["best_loss_model"]["similarity_gap"],
            "R@1": ret["recall@1"], "R@5": ret["recall@5"],
            "R@10": ret["recall@10"], "MRR": ret["mrr"],
            "mean rank": ret["mean_rank"]}


def main():
    runs = {k: load(v) for k, v in RUNS.items()
            if os.path.isfile(os.path.join(ROOT, "runs", v,
                                           "proxy_summary.json"))}
    names = list(runs)
    print("| Run | " + " | ".join(f"{k} ({RUNS[k]})" for k in names) + " |")
    print("| --- |" + " --- |" * len(names))
    n_ep = max(len(r["summary"]["val_gap_trajectory"]) for r in runs.values())
    for e in range(n_ep):
        print(f"| val gap, epoch {e + 1} | " + " | ".join(
            f"{r['summary']['val_gap_trajectory'][e]:.4f}" for r in
            runs.values()) + " |")
    for e in range(n_ep):
        print(f"| val loss / clean / corrupt, epoch {e + 1} | " + " | ".join(
            "{:.4f} / {:.4f} / {:.4f}".format(*r["val"][e + 1])
            if e + 1 in r["val"] else "—" for r in runs.values()) + " |")
    m = {k: metrics(r) for k, r in runs.items()}
    for key in ("test gap (best_gap)", "test gap (best_loss)", "R@1", "R@5",
                "R@10", "MRR", "mean rank"):
        print(f"| {key} | " + " | ".join(f"{m[k][key]:.4f}" for k in names)
              + " |")
    for key in ("recall@1", "mrr", "similarity_gap"):
        print(f"| int8 Δ{key} (pool) | " + " | ".join(
            f"{runs[k]['int8']['delta_int8_minus_fp'][key]:+.6f} "
            f"({runs[k]['int8']['pool']})" for k in names) + " |")
    for e in FIXED_EPOCHS:
        if not any(e in r["fixed"] for r in runs.values()):
            continue
        print(f"| epoch {e} model: R@1 / R@10, MRR, gap | " + " | ".join(
            "{recall@1:.4f} / {recall@10:.4f}, {mrr:.4f}, "
            "{similarity_gap:.4f}".format(**r["fixed"][e])
            if e in r["fixed"] else "—" for r in runs.values()) + " |")
    for e in range(n_ep):
        cells = []
        for r in runs.values():
            # a TPU's rate is no measure of the port: left out
            ep = [x for x in r["epochs"] if x[0] == e + 1
                  and r["card"] != "TPU (JAX)"]
            cells.append(f"{ep[0][2]:.2f}" + (f" / {ep[0][3]:.2f}" if ep[0][3]
                                              else "") + f" ({ep[0][1]:.1f} s)"
                         if ep else "—")
        print(f"| clips/s, epoch {e + 1} (host / warm; epoch s) | "
              + " | ".join(cells) + " |")
    for b in (32, 64, 96):
        print(f"| epoch 1, batch {b} | " + " | ".join(
            r["batches"].get(b, "—") for r in runs.values()) + " |")
    print("| device | " + " | ".join(r["card"] for r in runs.values()) + " |")

    print()
    if not {"A", "B"} <= set(m):
        print("no flags: runs A and B are both needed for the seed spread")
        return
    for key, floor in FLOORS.items():
        spread = abs(m["A"][key] - m["B"][key])
        bound = max(2 * spread, floor)
        for other in ("JAX", "C"):
            if other not in m:
                continue
            d = abs(m[other][key] - m["A"][key])
            flag = "FLAGGED" if d > bound else "ok"
            print(f"- {key}: |{other} − A| = {d:.4f} against max(2·|A − B| = "
                  f"{2 * spread:.4f}, floor {floor}) = {bound:.4f}: {flag}")
    for k in names:
        delta = runs[k]["int8"]["delta_int8_minus_fp"]
        for key, limit in INT8_LIMITS.items():
            flag = "FLAGGED" if abs(delta[key]) > limit else "ok"
            print(f"- int8 {k}: |Δ{key}| = {abs(delta[key]):.6f} against "
                  f"{limit}: {flag}")
    seeds = [k for k in SEEDS if k in runs]
    if "JAX" in runs and len(seeds) > 2:
        print()
        print(f"JAX against the port's {len(seeds)} seeds "
              f"({', '.join(seeds)}): range, mean ± sd, JAX's distance in sd")
        jax = runs["JAX"]
        rows = [(key, m["JAX"][key], [m[k][key] for k in seeds])
                for key in ("val gap, epoch 8", "test gap (best_gap)",
                            "test gap (best_loss)", "R@1", "MRR")]
        for e in range(1, n_ep + 1):
            for i, name in enumerate(("val loss", "val clean")):
                if e in jax["val"] and all(e in runs[k]["val"]
                                           for k in seeds):
                    rows.append((f"{name}, epoch {e}", jax["val"][e][i],
                                 [runs[k]["val"][e][i] for k in seeds]))
        fixed = [k for k in seeds if 6 in runs[k]["fixed"]]
        if len(fixed) > 1:
            # JAX's retrieval is of its best-gap model, which is its epoch 6
            rows.append((f"R@1, epoch 6 ({', '.join(fixed)})", m["JAX"]["R@1"],
                         [runs[k]["fixed"][6]["recall@1"] for k in fixed]))
            rows.append((f"MRR, epoch 6 ({', '.join(fixed)})", m["JAX"]["MRR"],
                         [runs[k]["fixed"][6]["mrr"] for k in fixed]))
        for key, want, got in rows:
            mean = sum(got) / len(got)
            sd = (sum((x - mean) ** 2 for x in got) / (len(got) - 1)) ** 0.5
            side = ("above all" if want > max(got) else "below all"
                    if want < min(got) else "inside")
            print(f"- {key}: JAX {want:.4f}; port {min(got):.4f}-"
                  f"{max(got):.4f}, {mean:.4f} ± {sd:.4f}; JAX "
                  f"{(want - mean) / sd:+.1f} sd, {side}")


if __name__ == "__main__":
    main()
