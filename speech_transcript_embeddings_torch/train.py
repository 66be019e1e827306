"""Training CLI of the port:

    python -m speech_transcript_embeddings_torch.train [preset=NAME] \\
        [device=cuda|cpu] [k=v ...]

The presets and the dotted ``k=v`` overrides are those of
``speech_transcript_embeddings_tpu.train`` (that module imports the JAX
training loop, so the table is copied here and a test holds the two equal).
All four presets run: ``tiny``, ``flagship`` and ``flagship-roberta`` with
the cross-modal fusion heads (and word alignment in the first two),
``retrieval`` without. ``device`` defaults to ``cuda``; ``cuda`` without a
card raises, and nothing falls back to the CPU. Rerunning with the same
``train.output_dir`` resumes from its ``latest`` checkpoint, mid-epoch
after a preemption (SIGTERM). Examples:

    # tiny synthetic smoke run on the CPU
    python -m speech_transcript_embeddings_torch.train preset=tiny \\
        device=cpu train.num_epochs=1 \\
        train.output_dir=speech_transcript_embeddings_torch/_build/torch_smoke

    # the reference-parity model at full width on one GPU (synthetic data)
    python -m speech_transcript_embeddings_torch.train preset=flagship \\
        data.synthetic_length_profile=cv \\
        train.output_dir=speech_transcript_embeddings_torch/_build/torch_flag

    # the retrieval recipe
    python -m speech_transcript_embeddings_torch.train preset=retrieval \\
        data.synthetic_length_profile=cv \\
        train.output_dir=speech_transcript_embeddings_torch/_build/torch_ret

Data parallel: one process per GPU, launched by ``torchrun``, which sets
the process group's environment; ``data.batch_size`` is the GLOBAL batch,
each of the N ranks trains on B/N of its rows, and NCCL averages the
gradients (gloo with ``device=cpu``). A launch with ``WORLD_SIZE`` > 1, or
``mesh.multihost=true``, joins the group before the run; ``device=cuda``
then means card ``LOCAL_RANK``. Only rank 0 writes files:

    torchrun --nproc_per_node=N -m speech_transcript_embeddings_torch.train \\
        preset=retrieval data.batch_size=64 \\
        train.output_dir=speech_transcript_embeddings_torch/_build/torch_dp

Tensor parallel: ``mesh.num_model=M`` splits the model over M ranks of
each data row, as JAX's ``model`` mesh axis does (``parallel/mesh.py``);
launch D·M processes. With one process ``mesh.num_model=2`` raises JAX's
``ValueError``. Checkpoints keep the one-process layout:

    torchrun --nproc_per_node=2 -m speech_transcript_embeddings_torch.train \\
        preset=tiny device=cpu mesh.num_model=2 \\
        train.output_dir=speech_transcript_embeddings_torch/_build/torch_tp
"""

from __future__ import annotations

import os
import sys

import torch

from speech_transcript_embeddings_torch import config as config_lib

_MPNET_TOKENIZER = "sentence-transformers/paraphrase-multilingual-mpnet-base-v2"
PRESETS = ("tiny", "flagship", "flagship-roberta", "retrieval")


def build_config(argv) -> config_lib.ExperimentConfig:
    """The JAX CLI's ``build_config``: a preset, then the overrides."""
    argv = list(argv)
    if any(a in ("--help", "-h", "help") for a in argv):
        raise SystemExit(__doc__)
    preset = None
    for item in list(argv):
        if item.startswith("preset="):
            preset = item.split("=", 1)[1]
            argv.remove(item)
    c = config_lib
    cfg = c.ExperimentConfig()
    partial = c.FreezeConfig(mode="partial", text_layers_to_unfreeze=5,
                             audio_layers_to_unfreeze=5)
    if preset == "tiny":
        cfg = c.ExperimentConfig(
            model=c.tiny_model_config(),
            data=c.DataConfig(
                dataset="synthetic", batch_size=8, max_text_length=16,
                audio_buckets=(16000, 48000), max_audio_samples=48000,
                num_synthetic_samples=64),
            optimizer=c.OptimizerConfig(learning_rate=1e-3, warmup_steps=5),
            train=c.TrainConfig(num_epochs=2, accumulation_steps=1,
                                plot_every=1))
    elif preset == "flagship":
        cfg = c.ExperimentConfig(
            model=c.flagship_model_config(), freeze=partial,
            optimizer=c.OptimizerConfig(mu_dtype="bfloat16"),
            data=c.DataConfig(tokenizer=_MPNET_TOKENIZER))
    elif preset == "retrieval":
        cfg = c.ExperimentConfig(
            model=c.retrieval_model_config(), freeze=partial,
            loss=c.LossConfig(kind="global"),
            optimizer=c.OptimizerConfig(mu_dtype="bfloat16"),
            data=c.DataConfig(tokenizer=_MPNET_TOKENIZER))
    elif preset == "flagship-roberta":
        cfg = c.ExperimentConfig(
            model=c.roberta_model_config(), freeze=partial,
            optimizer=c.OptimizerConfig(learning_rate=3e-5,
                                        mu_dtype="bfloat16"),
            data=c.DataConfig(
                tokenizer="sentence-transformers/all-roberta-large-v1"))
    elif preset is not None:
        raise SystemExit(f"Unknown preset {preset!r} (use {'|'.join(PRESETS)})")
    return cfg.with_overrides(config_lib.parse_overrides(argv))


def main(argv=None) -> dict:
    from speech_transcript_embeddings_torch.utils.env import load_dotenv
    load_dotenv()   # HF_TOKEN and the dataset paths, as the JAX CLI reads them
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    for item in list(argv):
        if item.startswith("device="):
            device = item.split("=", 1)[1]
            argv.remove(item)
    cfg = build_config(argv)
    from speech_transcript_embeddings_torch.parallel import collectives
    from speech_transcript_embeddings_torch.parallel import mesh as mesh_lib
    from speech_transcript_embeddings_torch.training.loop import run_experiment
    had_group = collectives.initialized()
    mesh_lib.maybe_initialize_distributed(
        cfg.mesh.multihost or int(os.environ.get("WORLD_SIZE", 1)) > 1,
        device)
    joined = not had_group and collectives.initialized()
    try:
        return run_experiment(cfg, device=device)
    finally:
        if joined:       # the group this call joined ends with it
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
