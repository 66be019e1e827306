# The port's copy of speech_transcript_embeddings_tpu/config.py: the port imports
# nothing of the JAX package. Keep the two in step.
"""Typed configuration for the TPU speech↔transcript embedding framework.

Replaces the reference's three nested config layers (argparse in
trainer_unfreeze.py:1846-1905, the 385-line bash flag wrapper, and Docker env) with a
single set of dataclasses plus ``key=value`` CLI overrides.

Known reference config quirks intentionally fixed here (SURVEY.md §7):
  * ``corruption_probability`` actually controls corruption (reference stored but never
    consulted it — trainer_unfreeze.py:769-770),
  * word alignment is controlled by config (reference hard-coded False at the call
    site — trainer_unfreeze.py:1953),
  * head input dims are derived from encoder configs (reference hard-coded 768/1024 —
    trainer_unfreeze.py:329-330),
  * the human-readable similarity temperature follows the loss temperature (reference
    hard-coded 0.1 — trainer_unfreeze.py:1121).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple, Union


def _replace_from_dict(obj, d: dict):
    """Recursively apply a (possibly nested) dict of overrides to a dataclass.
    A group whose dict names DeepSeek-V2's ``model_type`` starts from
    ``DeepseekV2TextConfig``'s defaults (a port-only rule: the JAX package
    has one text tower)."""
    updates = {}
    for k, v in d.items():
        if not hasattr(obj, k):
            raise ValueError(f"Unknown config field {k!r} for {type(obj).__name__}")
        cur = getattr(obj, k)
        if isinstance(v, dict) and \
                v.get("model_type") == DeepseekV2TextConfig.model_type and \
                not isinstance(cur, DeepseekV2TextConfig):
            cur = DeepseekV2TextConfig()
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            updates[k] = _replace_from_dict(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, list):
            updates[k] = tuple(v)   # JSON has no tuples
        else:
            updates[k] = v
    return dataclasses.replace(obj, **updates)


@dataclass(frozen=True)
class TextEncoderConfig:
    """RoBERTa/XLM-R-style bidirectional transformer encoder.

    Defaults are the ``paraphrase-multilingual-mpnet-base-v2`` (XLM-R base) geometry
    used by the reference's logged runs (SURVEY.md §2 "Pretrained encoders").
    """

    vocab_size: int = 250002
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1           # RoBERTa-style: position ids offset by pad_token_id+1
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    # fold the bottom N blocks into one lax.scan (see AudioEncoderConfig)
    scan_bottom: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class YarnRopeScaling:
    """DeepSeek-V2's ``rope_scaling`` group: YaRN frequencies (an interpolation
    by ``factor`` below the ``beta_slow`` … ``beta_fast`` rotation band) and
    the attention scale's ``mscale`` terms."""

    type: str = "yarn"
    factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707


@dataclass(frozen=True)
class DeepseekV2TextConfig:
    """A DeepSeek-V2 decoder as the transcript tower (port only; the JAX
    package has no such tower). Every key of the published ``config.json``
    under its own name; defaults are ``deepseek-ai/DeepSeek-V2-Lite``'s: 27
    pre-RMSNorm causal layers of width 2,048, latent attention (MLA: 16
    heads, no query compression, a 512-wide compressed KV and a 64-wide
    rotary key shared by the heads, YaRN rope), layer 0 a dense SwiGLU
    10,944 wide, layers 1-26 64 routed SwiGLU experts 1,408 wide (softmax
    router, greedy top-6, no renormalisation) plus 2 shared experts.
    ``model_type`` is the key that tells this group from
    ``TextEncoderConfig`` in a config's JSON (``_replace_from_dict``)."""

    model_type: str = "deepseek_v2"
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    routed_scaling_factor: float = 1.0
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128
    topk_method: str = "greedy"
    n_group: int = 1
    topk_group: int = 1
    num_experts_per_tok: int = 6
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = False
    scoring_func: str = "softmax"
    seq_aux: bool = True
    hidden_act: str = "silu"
    max_position_embeddings: int = 163840
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: YarnRopeScaling = field(default_factory=YarnRopeScaling)
    attention_bias: bool = False
    tie_word_embeddings: bool = False

    @property
    def num_layers(self) -> int:
        """The block count the freeze labels read (``layer_<i>``)."""
        return self.num_hidden_layers

    @property
    def scan_bottom(self) -> int:
        """No scanned bottom stack: the JAX package has no such tower."""
        return 0


@dataclass(frozen=True)
class AudioEncoderConfig:
    """w2v-bert-2.0-style conformer encoder over stacked log-mel features.

    Geometry mirrors ``facebook/w2v-bert-2.0`` (transformers Wav2Vec2BertConfig
    defaults): 24 conformer blocks, hidden 1024, relative_key position bias.
    """

    feature_dim: int = 160          # 80 mel bins × 2 stacked frames
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    conv_kernel_size: int = 31      # depthwise conv kernel (causal, left-padded)
    left_max_rel_pos: int = 64      # relative_key clamp window
    right_max_rel_pos: int = 8
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    conv_dropout: float = 0.1
    activation_dropout: float = 0.0
    feat_proj_dropout: float = 0.0
    # SpecAugment time masking (training only) — HF Wav2Vec2Bert applies this in
    # train mode with a learned masked_spec_embed vector, so the reference's
    # training runs had it active (mask_time_prob 0.05, length 10, min 2 spans)
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2
    # fold the bottom N homogeneous blocks into one lax.scan (stacked params):
    # several-fold faster tracing/compilation of the 24-block stack. Set to the
    # frozen-layer count (num_layers - layers_to_unfreeze); 0 = fully unrolled.
    scan_bottom: int = 0
    # fused Pallas flash attention with the in-tile banded relative_key bias
    # (ops/flash_attention.py); falls back to the XLA path when attention
    # dropout is active in train mode. Auto-interprets off-TPU.
    use_flash_attention: bool = False
    # remat policy for the per-block rematerialisation (ModelConfig.remat):
    #  'full'       — recompute everything in the backward replay (max HBM saving)
    #  'save_flash' — keep the flash kernel's (out, lse) so the replay skips
    #                 re-running the forward attention kernel (+[B,T,H]+[B·h,T,1]
    #                 per block of residency; measured 1.49× step time at the
    #                 flagship geometry, ROUND2.md). Requires
    #                 use_flash_attention; ignored otherwise.
    #  'save_hot'   — save_flash + the conv module output (+[B,T,H]/block):
    #                 the replay also skips the GLU/depthwise/pointwise convs.
    #                 Measured WORSE than save_flash at B=64 under f32 frozen
    #                 storage (HBM spill traffic); ~equal under bf16 frozen
    #                 storage and best with bf16 Adam mu (scripts/ab_remat.py).
    #  'save_hot2'  — save_hot + the ffn1 output (+[B,T,H]/block). SHIPPED in
    #                 the flagship/retrieval presets: fastest at every
    #                 per-device batch ≤ 32 (52.0 clips/s at B=16, the v5e-8
    #                 preset's per-chip batch, vs 51.1 under save_hot —
    #                 r3 ab_remat sweep). Does NOT fit at flagship B=64
    #                 (program HBM 11.4G, total >16G — recorded OOM, r3):
    #                 for single-chip runs with per-device batch ≥ 48,
    #                 override model.audio.remat_policy=save_hot.
    #  'save_hot3'  — save_hot2 + projected q/k/v (+3×[B,T,H]/block). Measured
    #                 SLOWER than save_hot2 at B=16 (317.5 vs 308.9 ms,
    #                 same-process A/B, r3): the extra HBM write+read traffic
    #                 of the saved tensors outweighs the three skipped
    #                 projection matmuls — the backward is bandwidth-bound,
    #                 not MXU-bound. Kept as a tested lever for future
    #                 geometries.
    remat_policy: str = "full"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class FrontendConfig:
    """Log-mel frontend matching the w2v-bert-2.0 (SeamlessM4T) feature extractor.

    Framing → remove-DC → preemphasis 0.97 → povey window → rFFT(512) → power →
    80-bin kaldi-mel filterbank (floor 2^-23) → ln → per-utterance per-bin norm →
    2-frame stacking to 160-dim features.
    """

    sampling_rate: int = 16000
    frame_length: int = 400         # 25 ms
    hop_length: int = 160           # 10 ms
    fft_length: int = 512
    num_mel_bins: int = 80
    min_frequency: float = 20.0
    max_frequency: float = 8000.0
    preemphasis: float = 0.97
    mel_floor: float = 1.192092955078125e-07  # 2**-23
    stride: int = 2                 # frame stacking factor
    per_bin_normalize: bool = True
    use_pallas: bool = False        # fused Pallas kernel (TPU) vs pure-jnp reference


@dataclass(frozen=True)
class HeadsConfig:
    """Projection / pooling / fusion heads shared by both modalities."""

    projection_dim: int = 768
    projection_hidden_dim: Optional[int] = None   # default 2 × projection_dim
    dropout: float = 0.1
    activation: str = "gelu"
    use_cross_modal: bool = True
    cross_modal_heads: int = 8
    use_attentive_pooling: bool = True
    use_word_alignment: bool = True
    alignment_heads: int = 4


@dataclass(frozen=True)
class ModelConfig:
    text: Union[TextEncoderConfig, DeepseekV2TextConfig] = field(
        default_factory=TextEncoderConfig)
    audio: AudioEncoderConfig = field(default_factory=AudioEncoderConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    heads: HeadsConfig = field(default_factory=HeadsConfig)
    # compute dtype for encoder matmuls; params stay float32
    dtype: str = "bfloat16"
    remat: bool = True              # rematerialise encoder blocks to save HBM

    @property
    def projection_dim(self) -> int:
        return self.heads.projection_dim


def flagship_model_config() -> "ModelConfig":
    """The flagship model/kernel block (`preset=flagship`): 877M mpnet +
    w2v-bert-2.0 geometry, bf16 compute with per-block remat, frozen bottoms
    scanned for the 5+5 recipe, Pallas flash attention under the save_hot2
    remat policy (save_flash + conv + ffn1 outputs — fits HBM at every
    documented per-device batch ≤ 32 since the frozen split is stored bf16
    and Adam's mu is bf16, and measured fastest; ROUND3.md ab_remat sweep),
    fused Pallas log-mel frontend (both kernels auto-fall-back off-TPU). The
    single source of truth shared by train.py's preset, __graft_entry__.py,
    bench.py and the measurement scripts — so every benchmark measures the
    shipped configuration."""
    return ModelConfig(
        text=TextEncoderConfig(scan_bottom=7),
        audio=AudioEncoderConfig(scan_bottom=19, use_flash_attention=True,
                                 remat_policy="save_hot2"),
        frontend=FrontendConfig(use_pallas=True),
    )


def retrieval_model_config() -> "ModelConfig":
    """The north-star retrieval model block (`preset=retrieval`): flagship
    geometry and kernels with the pair-fusion heads OFF — plain dual-encoder
    (encoder → attentive pooling → projection, L2-normalised). Cross-modal
    fusion mixes the two modalities per pair, so fused embeddings are
    pair-dependent and invalid for ranking; the round-2 proxy runs show the
    fused path memorizes under the global loss (train gap 0.25, val gap 0.03,
    chance retrieval) while this configuration reaches 80.6% Recall@1 on the
    4096-pool proxy (ROUND2.md, runs/proxy_midsize_retrieval_r2b). Pair with
    ``loss.kind='global'`` (train.py's ``preset=retrieval`` does both) for the
    BASELINE.json Recall@1 recipe — the counterpart of the reference's
    retrieval evaluation (cv_inference.py:185-202)."""
    base = flagship_model_config()
    return dataclasses.replace(
        base,
        heads=dataclasses.replace(base.heads, use_cross_modal=False,
                                  use_word_alignment=False),
    )


def roberta_model_config() -> "ModelConfig":
    """The reference's OTHER text-encoder configuration
    (`preset=flagship-roberta`): ``sentence-transformers/all-roberta-large-v1``
    (RobertaModel 24×1024×16h, vocab 50265 — reference model.py:137) paired
    with the same w2v-bert-2.0 audio encoder, projection_dim 1024 — the
    geometry of the reference's ``5_layers_wo_alignment`` /
    ``5_layers_wt_alignment`` logged runs (BASELINE.md rows 4-5: best-gap
    0.3580 at epoch 5, word-align OFF). Word alignment defaults OFF to match
    the better of those two runs; override ``model.heads.use_word_alignment``
    for the wt_alignment variant. Kernels/remat follow the flagship preset.
    Conversion/ingest at this geometry is validated end-to-end by
    ``scripts/validate_flagship_conversion.py --text-arch roberta-large``
    (runs/roberta_conversion_validation.txt)."""
    base = flagship_model_config()
    return dataclasses.replace(
        base,
        text=TextEncoderConfig(
            vocab_size=50265, hidden_size=1024, num_layers=24, num_heads=16,
            intermediate_size=4096, scan_bottom=19),
        heads=dataclasses.replace(base.heads, projection_dim=1024,
                                  use_word_alignment=False),
    )


def deepseek_v2_lite_model_config() -> "ModelConfig":
    """The retrieval preset with DeepSeek-V2-Lite as its transcript tower
    (`preset=deepseek-v2-lite`, port only): the published model whole, 27
    layers, 64 routed and 2 shared experts a layer, the whole vocabulary;
    attentive pooling and the projection to 768, no fusion or alignment
    heads. 15.49 B parameters in the tower (31.0 GB in bf16)."""
    return dataclasses.replace(retrieval_model_config(),
                               text=DeepseekV2TextConfig())


@dataclass(frozen=True)
class FreezeConfig:
    """Partial-unfreeze schedule: 'full' | 'partial' | 'none'.

    'partial' unfreezes the top-N transformer blocks of each encoder plus the audio
    feature projection and text pooler-equivalents, exactly mirroring the reference's
    requires_grad logic (trainer_unfreeze.py:354-434) — expressed here as optax param
    labels, and as a param split so frozen subtrees never enter the backward pass.
    """

    mode: str = "partial"
    text_layers_to_unfreeze: int = 5
    audio_layers_to_unfreeze: int = 5
    # storage dtype of the FROZEN param split. None = follow ModelConfig.dtype
    # (the compute dtype): with bf16 compute the frozen split (~509M params at
    # flagship geometry, ~1 GB) was stored f32 and cast to bf16 every step —
    # storing it bf16 halves its HBM residency AND its per-step read traffic
    # with zero optimizer-state implications (frozen params have no optimizer
    # state; the one-time rounding of pretrained weights to bf16 is the same
    # precision the compute path already uses). Set 'float32' to keep full
    # precision storage.
    frozen_dtype: Optional[str] = None
    # Reference parity leaves the text embeddings and the audio feature
    # projection trainable (they are never frozen by the per-layer loop,
    # trainer_unfreeze.py:366-401). They sit BELOW the frozen blocks, so
    # training them forces a full-depth backward pass; set both False to stop
    # backprop at the lowest unfrozen block — XLA then dead-code-eliminates
    # the backward (and its remat replay) through every frozen bottom block.
    # Measured 2.03× faster steps at flagship B=16 (307.3 → 151.4 ms,
    # 105.7 clips/s — scripts/ab_remat.py '+frozenemb', r3) and far smaller
    # optimizer state (the text embedding table alone is ~63% of the
    # reference's trainable params). Quality: measured in the r4 proxy
    # (runs/proxy_frozen_bottom_48, ROUND4.md) — from RANDOM init this lever
    # destroys quality (Recall@1 0.95% at epoch 16 of the 48-epoch schedule,
    # stopped there because the collapse was unambiguous — the val gap
    # plateaued at ~0.12 by epoch 6 vs the unfrozen baseline's 84.2% R@1 /
    # 0.359 gap at 48) because frozen random tables carry no signal; it is
    # sound only when the frozen bottom is pretrained (the reference's actual
    # setting). Measured in that regime (r5 warm-start A/B, ROUND5.md): both
    # arms warm-started from an 8-epoch midsize checkpoint and continued 2
    # epochs — frozen R@1 15.58% / MRR 0.256 vs unfrozen 15.77% / 0.260,
    # parity within noise while retrieval doubled in both arms. Not a preset
    # default (from-scratch collapse risk), but the recommended setting for
    # warm-started fine-tuning, which is every reference run's regime.
    train_text_embeddings: bool = True
    train_audio_feature_projection: bool = True


@dataclass(frozen=True)
class LossConfig:
    temperature: float = 0.1
    alignment_weight: float = 0.5   # reference instantiates with 0.5 (trainer:1523)
    corrupt_gamma: float = 0.35
    # 'pairwise' = reference-parity 2-way CE over [s_pos, s_neg]
    # 'global'   = TPU-native in-batch-negative InfoNCE, negatives all-gathered over
    #              the data mesh axis (BASELINE.json north star)
    kind: str = "pairwise"


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 5e-5
    encoder_lr_divisor: float = 50.0   # discriminative LR (trainer_unfreeze.py:1489)
    weight_decay: float = 0.01
    warmup_steps: int = 1000
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # storage dtype of the Adam first moment (optax ``mu_dtype``). ``bfloat16``
    # halves mu's HBM residency (~0.7 GB at flagship trainable size) at a
    # negligible numerics cost (mu is a smooth EMA; nu stays f32). None = f32.
    mu_dtype: Optional[str] = None


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"      # 'common_voice' | 'local' | 'synthetic'
    dataset_config: str = "pt"
    data_dir: Optional[str] = None
    # Tokenizer identity — travels with the model (the full config is stored in
    # every checkpoint's metadata.json, so inference/serving restore the exact
    # training tokenizer). The reference always tokenizes with the text model's
    # own tokenizer (trainer_unfreeze.py:1387, processor.py:33); this field
    # names it: an HF tokenizer name/path, or 'hash' for the offline
    # deterministic SimpleWordTokenizer. Resolution (data/tokenizers.py
    # resolve_tokenizer): synthetic data ALWAYS uses the hash tokenizer (its
    # text is generated pseudo-words — an HF vocab is meaningless and needs hub
    # access); common_voice REQUIRES an explicit value (None raises, loudly —
    # a wrong-vocab default would silently poison training and inference);
    # local defaults to 'hash' (the offline path). The presets set it to their
    # text encoder's tokenizer (train.py).
    tokenizer: Optional[str] = None
    max_text_length: int = 128
    max_audio_samples: int = 480000  # 30 s at 16 kHz
    corruption_probability: float = 1.0  # reference behavior: every sample corrupted
    # static-shape audio bucketing (in raw samples); each bucket compiles once.
    # Defaults chosen so the stacked feature length T = (1+(N-400)/160)/2 is a
    # multiple of 128 (MXU-aligned): T = 128/256/512/768/1536.
    audio_buckets: Tuple[int, ...] = (41200, 82160, 164080, 246000, 491760)
    batch_size: int = 16
    shuffle_seed: int = 42
    num_synthetic_samples: int = 256  # for the synthetic source
    # Synthetic clip-length profile: 'short' = 2-8 words (0.7-2.8 s clips,
    # the smoke-test default); 'cv' = the documented Common-Voice-pt
    # approximation (lognormal, median 4.2 s, sigma_log 0.45, mean ~4.7 s —
    # the same model bench.py::_sample_cv_lengths uses), with words =
    # round(seconds / 0.35 s-per-word) capped at synthetic_max_words so the
    # transcript fits max_text_length. 'cv' makes a synthetic flagship run
    # exercise the real bucketed length mix (multi-bucket programs, realistic
    # padding waste) instead of a single short bucket.
    synthetic_length_profile: str = "short"
    synthetic_max_words: int = 42   # 42 × 0.35 s = 14.7 s — inside the 15 s bucket
    # Directory for the persisted per-split audio-length histograms that feed
    # the exact LR schedule (train.exact_schedule). Computing them costs a
    # header scan (local WAV) or a full decode of every clip (common_voice,
    # local mp3) — paid once, then re-read from this cache by every resumed or
    # segmented child process instead of re-decoding the corpus. None =
    # ~/.cache/speech_transcript_embeddings_tpu/lengths (override with the
    # STE_LENGTH_CACHE_DIR env var); entries are keyed by dataset identity +
    # split + example count, so a dataset change invalidates them.
    length_cache_dir: Optional[str] = None
    # Load Common Voice from a local on-disk snapshot (``datasets.save_to_disk``
    # layout with train/validation/test splits) instead of the HF hub — for
    # airgapped TPU-VMs holding a pre-downloaded copy, and for the offline
    # readiness drill (tests/test_cv_readiness.py) that exercises every step
    # of docs/CV_RUNBOOK.md without egress. None = stream from the hub
    # (requires HF_TOKEN). Env fallback: STE_CV_LOCAL_DATASET_DIR.
    cv_local_dataset_dir: Optional[str] = None
    # fetch/decode examples with this many threads (ordered, bounded
    # look-ahead; 0/1 = sequential). Batches are byte-identical to the
    # sequential path — the corruption rng stream stays in the consumer.
    # Audio decode (C++ WAV / soundfile) releases the GIL, so this scales the
    # host pipeline on many-core TPU-VM hosts; requires a thread-safe
    # source.example_at (all built-in sources are).
    decode_workers: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh. data = DP axis (batch + all-gathered negatives over ICI);
    model = TP axis for the encoder matmuls."""

    data_axis: str = "data"
    model_axis: str = "model"
    num_data: int = -1              # -1: all devices on the data axis
    num_model: int = 1
    # multi-host (multi-slice) mode: jax.distributed.initialize() at startup
    # and per-host batch shards assembled into global arrays
    # (parallel/mesh.py::shard_batch_multihost). batch_size is then the GLOBAL
    # batch; each host feeds batch_size / process_count rows. Single-host runs
    # (this repo's test env and the v5e-8 target) leave this False.
    multihost: bool = False


@dataclass(frozen=True)
class TrainConfig:
    num_epochs: int = 30
    # compute the LR schedule for this many total epochs instead of
    # num_epochs (None = num_epochs). Needed when a long run is chained
    # across resumed processes each running to an intermediate num_epochs
    # (e.g. proxy_quality_run --segment-epochs): without it every segment
    # decays the LR toward its own end — a sawtooth, not one linear decay.
    schedule_epochs: Optional[int] = None
    accumulation_steps: int = 4     # microbatch scan inside the jitted step
    save_every: int = 1
    eval_every: int = 1
    plot_every: int = 5
    seed: int = 42
    output_dir: str = "./runs/audio_text_model"
    resume: bool = True             # reference had no resume path; we do
    # params-only checkpoint (convert_checkpoint.py output) to initialise from
    init_checkpoint: Optional[str] = None
    validate_gradients: bool = False   # run the grad-accum self-check up front
    # count the true batches/epoch from the source's audio-length histogram so
    # the LR decay endpoint is exact under bucketed drop_last (falls back to
    # N//batch_size when the source reports no lengths)
    exact_schedule: bool = True
    log_every_batches: int = 50
    # capture a jax.profiler trace of a few warm steps into this directory
    profile_dir: Optional[str] = None
    profile_steps: int = 3
    prefetch_batches: int = 2          # host-side batch prefetch depth (0 = off)
    # swallow per-epoch exceptions and continue (reference behavior,
    # trainer_unfreeze.py:1720-1722); default off = fail fast
    continue_on_epoch_error: bool = False
    # preemption safety (TPU-VM spot/maintenance events deliver SIGTERM): on
    # SIGTERM the loop checkpoints ``latest`` at the next batch boundary with
    # mid-epoch resume metadata and exits cleanly; resume replays the seeded
    # epoch stream and skips the already-trained batches (exact — the pipeline
    # is deterministic per (seed, epoch)). The reference loses the whole run.
    preempt_checkpoint: bool = True
    # fault injection for the preemption path (SURVEY §5.3): simulate a
    # preemption after N batches of the first epoch this process runs
    fault_inject_preempt_at: Optional[int] = None


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    freeze: FreezeConfig = field(default_factory=FreezeConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return _replace_from_dict(cls(), json.loads(s))

    def with_overrides(self, overrides: dict) -> "ExperimentConfig":
        return _replace_from_dict(self, overrides)


def tiny_model_config(
    *,
    text_hidden: int = 32,
    audio_hidden: int = 48,
    projection_dim: int = 24,
    num_layers: int = 2,
    vocab_size: int = 128,
    use_word_alignment: bool = True,
) -> ModelConfig:
    """Small geometry for tests / CPU smoke runs."""
    return ModelConfig(
        text=TextEncoderConfig(
            vocab_size=vocab_size, hidden_size=text_hidden, num_layers=num_layers,
            num_heads=4, intermediate_size=text_hidden * 4,
            max_position_embeddings=96, hidden_dropout=0.0, attention_dropout=0.0,
        ),
        audio=AudioEncoderConfig(
            feature_dim=16, hidden_size=audio_hidden, num_layers=num_layers,
            num_heads=4, intermediate_size=audio_hidden * 4, conv_kernel_size=7,
            left_max_rel_pos=8, right_max_rel_pos=2, conv_dropout=0.0,
            apply_spec_augment=False,
        ),
        frontend=FrontendConfig(num_mel_bins=8, stride=2),
        heads=HeadsConfig(
            projection_dim=projection_dim, dropout=0.0,
            cross_modal_heads=4, alignment_heads=2,
            use_word_alignment=use_word_alignment,
        ),
        dtype="float32",
        remat=False,
    )


def parse_overrides(argv: list) -> dict:
    """Parse ``a.b.c=value`` CLI override strings into a nested dict.

    Values are parsed as JSON when possible, else kept as strings, so
    ``train.num_epochs=30``, ``loss.kind=global`` and ``data.audio_buckets=[48000]``
    all work.
    """
    out: dict = {}
    for item in argv:
        if "=" not in item:
            raise ValueError(f"Override {item!r} is not of the form key=value")
        key, _, raw = item.partition("=")
        try:
            value: Any = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out
