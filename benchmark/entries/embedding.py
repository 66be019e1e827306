"""The embed cells' program and judgement: the program's ``Embedder`` over the
serving model that holds the benchmark's weights, the reference's
embeddings of a sample of clips, and the gap between the two.

``correct`` compares the embedding each sampled clip got back from the
timed path with the reference's (``reference/model.py`` in fp32, the
frontend in float64): the widest L2 distance between the two unit vectors
over the sample.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from benchmark import common, traffic
from benchmark.reference import model as ref_model
from benchmark.weights import make_weights

REF_ROWS = 8             # clips a reference call


def make_embedder(torch, cell, seed: int, device, variant=None):
    """The program's ``Embedder`` for the cell, its weights made from
    ``seed``; ``variant="int8"`` switches on the program's int8 path (the
    control)."""
    from speech_transcript_embeddings_torch.inference.embed import Embedder
    cfg = common.port_config(cell.config, cell.mix)
    weights = make_weights(cell.config, seed, device)
    model = common.build_model(torch, cfg, weights, False, device)
    del weights
    embedder = Embedder(cfg, model)
    if variant == "int8":
        embedder.quantize_int8()
    elif variant is not None:
        raise ValueError(f"unknown variant {variant!r}")
    return embedder


def sample(rng: np.random.Generator, lens: Sequence[int], n: int
           ) -> List[int]:
    """``n`` indices drawn from ``rng`` among ``lens``, and the longest."""
    idx = set(rng.choice(len(lens), size=min(n, len(lens)),
                         replace=False).tolist())
    idx.add(int(np.argmax(lens)))
    return sorted(idx)


def reference_embeddings(torch, config: dict, seed: int,
                         clips: Sequence[np.ndarray], buckets: Sequence[int],
                         device, precision: str = "fp32") -> np.ndarray:
    """The reference's serving embedding of each clip (host arrays of its
    valid samples), a few clips a call, each call at the bucket of its
    longest clip: ``[len(clips), D]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = make_weights(config, seed, device)
    ref = ref_model.Reference(config["model"], weights, precision)
    order = sorted(range(len(clips)), key=lambda i: len(clips[i]))
    out = np.zeros((len(clips), config["model"]["heads"]["projection_dim"]),
                   np.float32)
    with torch.no_grad():
        for at in range(0, len(order), REF_ROWS):
            rows = order[at:at + REF_ROWS]
            width = traffic.bucket_of(max(len(clips[i]) for i in rows),
                                      buckets)
            wav = np.zeros((len(rows), width), np.float32)
            lens = []
            for j, i in enumerate(rows):
                a = np.asarray(clips[i], np.float32)[:width]
                peak = np.abs(a).max() if len(a) else 0.0
                wav[j, :len(a)] = a / peak if peak > 1.0 else a
                lens.append(len(a))
            emb = ref.embed_audio(torch.from_numpy(wav).to(device),
                                  torch.tensor(lens, device=device))
            out[rows] = emb.cpu().numpy()
    return out


def embedding_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """The widest L2 distance between a clip's two embeddings."""
    return float(np.max(np.linalg.norm(prog - ref, axis=1)))


def readings(torch, cell, seed: int, clips: List[np.ndarray],
             answers: List[np.ndarray], device) -> Dict[str, float]:
    ref = reference_embeddings(torch, cell.config, seed, clips,
                               cell.mix["buckets"], device)
    return {"embedding_gap": embedding_gap(np.stack(answers), ref)}
