# The port's copy of speech_transcript_embeddings_tpu/utils/artifacts.py: the port imports
# nothing of the JAX package. Keep the two in step.
"""Run artifacts: logging, metric files and plots in the reference's schema.

Byte-compatible artifact names and JSON keys (SURVEY.md §5.5): per-run
``training.log``, ``test_metrics.json`` with ``best_loss_model`` /
``best_gap_model`` blocks, ``similarity_dist_epoch_{N}.png``,
``clean_corrupt_progress.png``, ``test_similarity_dist_best_{loss,gap}.png``,
and the CV inference ``cv_results/cv_similarities.csv``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

_LOG_FORMAT = "%(asctime)s - %(levelname)s - %(message)s"


def setup_run_logging(output_dir: str, name: str = "ste_torch") -> logging.Logger:
    os.makedirs(output_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False   # avoid duplicate lines via the root handler
    if not any(isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        console = logging.StreamHandler()
        console.setFormatter(logging.Formatter(_LOG_FORMAT, datefmt="%m/%d/%Y %H:%M:%S"))
        logger.addHandler(console)
    log_path = os.path.join(output_dir, "training.log")
    if not any(isinstance(h, logging.FileHandler)
               and getattr(h, "baseFilename", None) == os.path.abspath(log_path)
               for h in logger.handlers):
        fh = logging.FileHandler(log_path)
        fh.setFormatter(logging.Formatter(_LOG_FORMAT))
        logger.addHandler(fh)
    return logger


def eval_metrics_dict(loss: float, clean_hr: Sequence[float],
                      corrupt_hr: Sequence[float]) -> Dict[str, float]:
    """The reference's evaluation metric block (trainer_unfreeze.py:1275-1283)."""
    clean_hr = np.asarray(clean_hr, np.float64)
    corrupt_hr = np.asarray(corrupt_hr, np.float64)
    return {
        "loss": float(loss),
        "avg_similarity": float(clean_hr.mean()) if clean_hr.size else 0.0,
        "median_similarity": float(np.median(clean_hr)) if clean_hr.size else 0.0,
        "std_similarity": float(clean_hr.std()) if clean_hr.size else 0.0,
        "clean_similarity": float(clean_hr.mean()) if clean_hr.size else 0.0,
        "corrupt_similarity": float(corrupt_hr.mean()) if corrupt_hr.size else 0.0,
        "similarity_gap": (float(clean_hr.mean()) - float(corrupt_hr.mean())
                           if clean_hr.size else 0.0),
    }


def write_test_metrics(output_dir: str, results: Dict[str, dict]) -> str:
    path = os.path.join(output_dir, "test_metrics.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    return path


def plot_similarity_distributions(clean: Sequence[float], corrupt: Sequence[float],
                                  output_path: str) -> Optional[str]:
    """Histogram overlay of raw cosines with dashed mean lines."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:                      # matplotlib optional
        return None
    plt.figure(figsize=(10, 6))
    plt.hist(clean, alpha=0.7, bins=30, label="Clean Samples", color="green")
    plt.hist(corrupt, alpha=0.7, bins=30, label="Corrupted Samples", color="red")
    plt.axvline(float(np.mean(clean)), color="green", linestyle="dashed", linewidth=2,
                label=f"Clean Mean: {np.mean(clean):.3f}")
    plt.axvline(float(np.mean(corrupt)), color="red", linestyle="dashed", linewidth=2,
                label=f"Corrupt Mean: {np.mean(corrupt):.3f}")
    plt.xlabel("Cosine Similarity")
    plt.ylabel("Frequency")
    plt.title("Distribution of Similarities for Clean vs Corrupted Samples")
    plt.legend()
    plt.grid(alpha=0.3)
    plt.savefig(output_path)
    plt.close()
    return output_path


def plot_progress(clean_history: List[float], corrupt_history: List[float],
                  output_path: str) -> Optional[str]:
    """Per-epoch clean/corrupt similarity progress chart."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    epochs = list(range(1, len(clean_history) + 1))
    plt.figure(figsize=(12, 6))
    plt.plot(epochs, clean_history, "g-", label="Clean Samples")
    plt.plot(epochs, corrupt_history, "r-", label="Corrupted Samples")
    plt.fill_between(epochs, clean_history, corrupt_history, color="lightgreen",
                     alpha=0.3, label="Similarity Gap")
    plt.xlabel("Epoch")
    plt.ylabel("Average Similarity")
    plt.title("Clean vs Corrupted Sample Performance Over Training")
    plt.legend()
    plt.grid(alpha=0.3)
    plt.tight_layout()
    plt.savefig(output_path)
    plt.close()
    return output_path
