"""Conversion CLI: foreign weights → a port checkpoint.

Port of ``speech_transcript_embeddings_tpu/convert_checkpoint.py``. Two
sources, one output: a params checkpoint of the port (``metadata.json`` +
``model.pt``, ``checkpoints.save_params_checkpoint``) that
``train.init_checkpoint=DIR``, ``serve --checkpoint DIR`` and ``infer
--checkpoint DIR`` load as they are.

* The HF encoders the reference consumes through ``AutoModel.from_pretrained``
  (needs ``transformers`` and the hub, or its cache): both encoders are
  renamed onto the port's modules (``models/convert.py``), the heads are
  initialised from ``--seed``::

    python -m speech_transcript_embeddings_torch.convert_checkpoint \\
        --text-model sentence-transformers/paraphrase-multilingual-mpnet-base-v2 \\
        --audio-model facebook/w2v-bert-2.0 \\
        --projection-dim 768 --output ./converted/mpnet_w2vbert

* A trained reference checkpoint (``best_model_gap.pt``), config sniffed
  from its keys (``models/ingest_torch.py``); needs torch alone::

    python -m speech_transcript_embeddings_torch.convert_checkpoint \\
        --from-torch best_model_gap.pt --output ./converted/reference

``--device`` (default ``cuda``) is where the HF path initialises the heads
and assembles the model; ``cuda`` without a card raises. ``--from-torch``
initialises nothing and works on the host. A ``.env`` in the
working directory is read first (``HF_TOKEN`` for gated hub models); shell
variables win.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from speech_transcript_embeddings_torch import checkpoints as ckpt_lib
from speech_transcript_embeddings_torch import config as config_lib
from speech_transcript_embeddings_torch.inference.embed import resolve_device
from speech_transcript_embeddings_torch.models import convert
from speech_transcript_embeddings_torch.models.dual_encoder import (
    DualEncoderModel, init_model,
)


def build_converted_params(text_hf, audio_hf, heads_cfg=None, seed: int = 0,
                           dtype: str = "bfloat16", device="cuda"):
    """(HF text model, HF audio model) → (ExperimentConfig, model).

    ``text_hf`` / ``audio_hf`` are instantiated HF torch models of any size
    (the tests build tiny random ones). The model is the training form
    (fp32 weights, as a fresh ``init_model(train=True)``): its heads are
    drawn from ``seed`` on ``device``, its encoders are the HF weights,
    loaded with ``strict=True``; a SpecAugment vector the source lacks keeps
    its initial value, as in the JAX converter."""
    device = resolve_device(device)
    text_cfg = convert.text_config_from_hf(text_hf.config)
    audio_cfg = convert.audio_config_from_hf(audio_hf.config)
    heads_cfg = heads_cfg or config_lib.HeadsConfig()
    frontend_cfg = config_lib.FrontendConfig()
    feat = audio_cfg.feature_dim
    if frontend_cfg.num_mel_bins * frontend_cfg.stride != feat:
        frontend_cfg = dataclasses.replace(
            frontend_cfg,
            num_mel_bins=feat // frontend_cfg.stride)
    model_cfg = config_lib.ModelConfig(
        text=text_cfg, audio=audio_cfg, heads=heads_cfg,
        frontend=frontend_cfg, dtype=dtype)
    cfg = config_lib.ExperimentConfig(model=model_cfg)

    model = init_model(model_cfg, torch.Generator(device).manual_seed(seed),
                       device, train=True).requires_grad_(False)
    model.text_encoder.load_state_dict(convert.convert_text_encoder(
        text_hf.state_dict(), text_cfg), strict=True)
    audio = convert.convert_audio_encoder(audio_hf.state_dict(), audio_cfg)
    own = model.audio_encoder.state_dict()
    if "masked_spec_embed" in own:
        audio.setdefault("masked_spec_embed", own["masked_spec_embed"])
    else:
        audio.pop("masked_spec_embed", None)
    model.audio_encoder.load_state_dict(audio, strict=True)
    return cfg, model


def from_reference(path: str):
    """A reference ``*.pt`` → (ExperimentConfig, model on the CPU holding
    the checkpoint's own tensors: nothing is initialised or copied)."""
    from speech_transcript_embeddings_torch.models import ingest_torch
    cfg, state = ingest_torch.load_reference_checkpoint(path)
    with torch.device("meta"):
        model = DualEncoderModel(cfg.model, torch.float32)
    model.load_state_dict(state, strict=True, assign=True)
    return cfg, model.requires_grad_(False)


def main(argv=None) -> dict:
    from speech_transcript_embeddings_torch.utils.env import load_dotenv
    load_dotenv()   # HF_TOKEN for the hub's gated or private models
    p = argparse.ArgumentParser(
        description="Convert HF encoders or a reference checkpoint to a "
                    "port checkpoint")
    p.add_argument("--text-model", default="sentence-transformers/"
                   "paraphrase-multilingual-mpnet-base-v2")
    p.add_argument("--audio-model", default="facebook/w2v-bert-2.0")
    p.add_argument("--projection-dim", type=int, default=768)
    p.add_argument("--no-word-alignment", action="store_true")
    p.add_argument("--no-cross-modal", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--from-torch", metavar="CKPT_PT",
                   help="ingest a trained reference torch checkpoint "
                        "(best_model_gap.pt etc.) instead of HF encoders; "
                        "config is reconstructed from its metadata/keys")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    if args.from_torch:
        print(f"Ingesting reference checkpoint {args.from_torch} ...")
        cfg, model = from_reference(args.from_torch)
        info = {"source": args.from_torch, "kind_detail": "reference_torch"}
    else:
        from transformers import AutoModel
        print(f"Loading {args.text_model} ...")
        text_hf = AutoModel.from_pretrained(args.text_model)
        print(f"Loading {args.audio_model} ...")
        audio_hf = AutoModel.from_pretrained(args.audio_model)
        heads = config_lib.HeadsConfig(
            projection_dim=args.projection_dim,
            use_cross_modal=not args.no_cross_modal,
            use_word_alignment=not args.no_word_alignment)
        cfg, model = build_converted_params(text_hf, audio_hf, heads,
                                            args.seed, device=args.device)
        info = {"text_model": args.text_model,
                "audio_model": args.audio_model}
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nbytes = ckpt_lib.save_params_checkpoint(args.output, model, cfg,
                                             info=info)
    save_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    print(f"Saved {n:,}-param checkpoint to {args.output} "
          f"({nbytes / 1e9:.3f} GB; read + convert {load_s:.3f} s, "
          f"write {save_s:.3f} s)")
    return {"cfg": cfg, "n_params": n, "bytes": nbytes,
            "load_seconds": load_s, "save_seconds": save_s}


if __name__ == "__main__":
    main()
