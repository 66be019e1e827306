# The port's copy of speech_transcript_embeddings_tpu/data/sources.py: the port imports
# nothing of the JAX package. Keep the two in step.
"""Dataset sources: Common Voice (HF hub), local directory, and synthetic.

A source yields ``Example(sentence, audio, sampling_rate)`` rows per split. The
reference streams ``mozilla-foundation/common_voice_17_0`` config ``pt`` from the
hub and casts audio to 16 kHz (trainer_unfreeze.py:1923-1927); that path is kept
(gated on hub availability) while tests and offline benches use the synthetic
source.

The synthetic source generates speech-like audio with a *learnable* audio↔text
correspondence: every word deterministically maps to a short dual-tone chirp, and a
sentence is the concatenation of its words' chirps plus noise. A model must
therefore align tone content with token identities to separate clean from corrupted
transcripts — which gives end-to-end smoke tests a real training signal.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterator, List

import numpy as np

from speech_transcript_embeddings_torch.config import DataConfig


@dataclasses.dataclass
class Example:
    sentence: str
    audio: np.ndarray        # float32 waveform in [-1, 1]
    sampling_rate: int


_PSEUDO_WORDS = (
    "casa tempo dia vida ano olhos cidade mundo noite terra parte homem mulher "
    "coisa momento agua luz caminho palavra historia trabalho musica porta mar "
    "sol amigo familia livro cor flor vento chuva pedra rio campo estrela fogo "
    "sonho viagem festa jogo escola carta nome ideia arte paz amor"
).split()


def _word_tones(word: str, num_tones: int = 2) -> List[float]:
    h = hashlib.sha1(word.lower().encode()).digest()
    return [200.0 + (int.from_bytes(h[4 * i: 4 * i + 4], "little") % 3000)
            for i in range(num_tones)]


def synth_audio_for_sentence(sentence: str, sampling_rate: int = 16000,
                             seconds_per_word: float = 0.35,
                             noise: float = 0.05,
                             seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pieces = []
    n_word = int(seconds_per_word * sampling_rate)
    t = np.arange(n_word) / sampling_rate
    env = np.hanning(n_word)
    for word in sentence.split():
        f1, f2 = _word_tones(word)
        tone = 0.45 * np.sin(2 * np.pi * f1 * t) + 0.35 * np.sin(2 * np.pi * f2 * t)
        pieces.append((tone * env).astype(np.float32))
    if not pieces:
        pieces = [np.zeros(n_word, np.float32)]
    audio = np.concatenate(pieces)
    audio = audio + rng.normal(scale=noise, size=audio.shape).astype(np.float32)
    peak = np.abs(audio).max()
    if peak > 1.0:
        audio = audio / peak
    return audio.astype(np.float32)


class SyntheticSource:
    """Deterministic synthetic speech/transcript pairs (per split).

    Index-addressable: example ``i`` is derived from a per-index seed, so a
    full-epoch permutation (``example_at``) and cheap length queries
    (``audio_lengths`` — no audio synthesis) are both exact.
    """

    def __init__(self, cfg: DataConfig, seed: int = 1234):
        self.cfg = cfg
        self.seed = seed

    def num_examples(self, split: str) -> int:
        n = self.cfg.num_synthetic_samples
        return {"train": n, "validation": max(n // 4, 1), "test": max(n // 4, 1)}[split]

    def _example_rng(self, split: str, i: int) -> np.random.Generator:
        split_salt = {"train": 0, "validation": 1, "test": 2}[split]
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, 1000 * split_salt, i]))

    def _n_words(self, rng: np.random.Generator) -> int:
        """Words for one clip — the per-index rng's FIRST draw(s), so
        ``audio_lengths`` can replay it without synthesizing audio.

        'short': uniform 2-8 words (0.7-2.8 s) — the smoke-test default.
        'cv': the documented CV-pt duration approximation (lognormal,
        median 4.2 s, sigma_log 0.45 — bench.py::_sample_cv_lengths),
        converted to words at 0.35 s/word and capped so the transcript fits
        ``max_text_length``.
        """
        if self.cfg.synthetic_length_profile == "cv":
            secs = float(np.clip(rng.lognormal(np.log(4.2), 0.45), 1.0, 30.0))
            return int(np.clip(round(secs / 0.35), 3,
                               self.cfg.synthetic_max_words))
        return int(rng.integers(2, 9))

    def example_at(self, split: str, i: int) -> Example:
        rng = self._example_rng(split, i)
        n_words = self._n_words(rng)
        words = [_PSEUDO_WORDS[rng.integers(len(_PSEUDO_WORDS))]
                 for _ in range(n_words)]
        sentence = " ".join(words)
        audio = synth_audio_for_sentence(
            sentence, seed=int(rng.integers(2 ** 31)))
        return Example(sentence, audio, 16000)

    def examples(self, split: str) -> Iterator[Example]:
        for i in range(self.num_examples(split)):
            yield self.example_at(split, i)

    def audio_lengths(self, split: str) -> List[int]:
        """Raw waveform lengths without synthesizing any audio: the length is
        ``n_words`` (the per-index rng's first draw(s)) × the per-word sample
        count of ``synth_audio_for_sentence``."""
        n_word = int(0.35 * 16000)
        return [self._n_words(self._example_rng(split, i)) * n_word
                for i in range(self.num_examples(split))]


def _length_cache_path(cfg: DataConfig, key: str) -> str:
    """On-disk home of a persisted length histogram (see
    DataConfig.length_cache_dir)."""
    import os
    root = (cfg.length_cache_dir
            or os.environ.get("STE_LENGTH_CACHE_DIR")
            or os.path.expanduser(
                "~/.cache/speech_transcript_embeddings_tpu/lengths"))
    return os.path.join(root, key + ".json")


def _load_cached_lengths(path: str, expected_n: int):
    """→ cached lengths list, or None when absent/stale (wrong example count —
    the dataset changed under the cache)."""
    import json
    import os
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    lengths = data.get("lengths")
    if not isinstance(lengths, list) or len(lengths) != expected_n:
        return None
    return lengths


def _store_cached_lengths(path: str, lengths) -> None:
    import json
    import os
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"lengths": [int(x) for x in lengths]}, f)
    os.replace(tmp, path)


class CommonVoiceSource:
    """Mozilla Common Voice via HF datasets (requires hub access + acceptance).

    Mirrors the reference's loading path (trainer_unfreeze.py:1923-1927).
    """

    def __init__(self, cfg: DataConfig):
        import os
        self.cfg = cfg
        local = (cfg.cv_local_dataset_dir
                 or os.environ.get("STE_CV_LOCAL_DATASET_DIR"))
        self._local_key = None
        self._local_root = None
        if local:
            # airgapped path: a pre-downloaded snapshot in save_to_disk
            # layout — everything downstream (16 kHz normalization, splits,
            # length cache, tokenizer resolution) is identical to the hub
            # path, so the offline readiness drill exercises the real run's
            # code. The audio column may be an Audio feature, raw float
            # arrays, or file paths (decoded by the native audio library).
            from datasets import load_from_disk
            self._ds = load_from_disk(local)
            self._local_key = hashlib.sha1(
                os.path.abspath(local).encode()).hexdigest()[:12]
            self._local_root = os.path.abspath(local)
        else:
            from datasets import Audio, load_dataset
            self._ds = load_dataset("mozilla-foundation/common_voice_17_0",
                                    cfg.dataset_config, token=True)
            self._ds = self._ds.cast_column("audio",
                                            Audio(sampling_rate=16000))

    def _row_audio(self, row) -> np.ndarray:
        """Audio of one row as a float32 16 kHz waveform, whatever the stored
        schema: a decoded Audio-feature dict (hub path), raw float samples
        (+ optional ``sampling_rate`` column), or a file path handed to the
        native decoder."""
        import os
        a = row["audio"]
        if isinstance(a, dict):                      # Audio feature decode
            wav = np.asarray(a["array"], np.float32)
            sr = int(a.get("sampling_rate", 16000))
        elif isinstance(a, str):                     # path → native decode
            from speech_transcript_embeddings_torch.data import native_audio
            p = (a if os.path.isabs(a)
                 else os.path.join(self._local_root or ".", a))
            with open(p, "rb") as f:
                wav, sr = native_audio.decode_audio(f.read(), p)
        else:                                        # raw sample sequence
            wav = np.asarray(a, np.float32)
            sr = int(row.get("sampling_rate", 16000))
        if sr != 16000:
            from speech_transcript_embeddings_torch.data import native_audio
            wav = native_audio.resample(wav, sr, 16000)
        return wav

    def num_examples(self, split: str) -> int:
        return len(self._ds[split])

    def example_at(self, split: str, i: int) -> Example:
        row = self._ds[split][int(i)]
        return Example(row["sentence"], self._row_audio(row), 16000)

    def examples(self, split: str) -> Iterator[Example]:
        for row in self._ds[split]:
            yield Example(row["sentence"], self._row_audio(row), 16000)

    def audio_lengths(self, split: str) -> List[int]:
        """Decoded waveform lengths. HF datasets has no cheap duration column
        for Common Voice, so computing these decodes each clip once — tens of
        minutes on the full corpus. The result is therefore persisted to the
        on-disk length cache (DataConfig.length_cache_dir) keyed by dataset
        config + split + example count, so resumed and segmented child
        processes (proxy_quality_run --segment-epochs chains) re-read it
        instead of re-decoding every split."""
        cache = getattr(self, "_length_cache", None)
        if cache is None:
            cache = self._length_cache = {}
        if split not in cache:
            n = self.num_examples(split)
            ident = (f"local_{self._local_key}" if self._local_key
                     else self.cfg.dataset_config)
            path = _length_cache_path(
                self.cfg, f"common_voice_17_{ident}_{split}_{n}")
            lengths = _load_cached_lengths(path, n)
            if lengths is None:
                lengths = [len(self._row_audio(row))
                           for row in self._ds[split]]
                _store_cached_lengths(path, lengths)
            cache[split] = lengths
        return cache[split]


class LocalSource:
    """Local dataset: ``<data_dir>/<split>.tsv`` with ``path\tsentence`` rows and
    mono WAV files, decoded/resampled by the native C++ audio library (scipy
    fallback inside data/native_audio.py)."""

    def __init__(self, cfg: DataConfig):
        import os
        self.cfg = cfg
        self.root = cfg.data_dir or "."
        self._rows = {}
        for split in ("train", "validation", "test"):
            path = os.path.join(self.root, f"{split}.tsv")
            rows = []
            if os.path.exists(path):
                with open(path) as f:
                    for line in f:
                        p, _, sent = line.rstrip("\n").partition("\t")
                        if p:
                            rows.append((p, sent))
            self._rows[split] = rows

    def num_examples(self, split: str) -> int:
        return len(self._rows[split])

    def example_at(self, split: str, i: int) -> Example:
        import os
        from speech_transcript_embeddings_torch.data import native_audio
        rel, sentence = self._rows[split][int(i)]
        with open(os.path.join(self.root, rel), "rb") as f:
            wav, sr = native_audio.decode_audio(f.read(), rel)
        if sr != 16000:
            wav = native_audio.resample(wav, sr, 16000)
        return Example(sentence, wav, 16000)

    def examples(self, split: str) -> Iterator[Example]:
        for i in range(len(self._rows[split])):
            yield self.example_at(split, i)

    def audio_lengths(self, split: str) -> List[int]:
        """Post-resample lengths from the WAV headers only (no sample decode);
        non-WAV rows (e.g. mp3) fall back to a full decode of that row. The
        histogram is persisted to the on-disk length cache (keyed by data_dir
        + split + row count) so segmented/resumed processes skip even the
        header scan — and, for mp3 corpora, the full decode."""
        import hashlib as _hashlib
        import os
        cache = getattr(self, "_length_cache", None)
        if cache is None:
            cache = self._length_cache = {}
        if split in cache:
            return cache[split]
        n_rows = len(self._rows[split])
        root_key = _hashlib.sha1(
            os.path.abspath(self.root).encode()).hexdigest()[:12]
        path = _length_cache_path(self.cfg,
                                  f"local_{root_key}_{split}_{n_rows}")
        out = _load_cached_lengths(path, n_rows)
        if out is None:
            out = []
            for i, (rel, _) in enumerate(self._rows[split]):
                n = _wav_header_num_samples(os.path.join(self.root, rel))
                if n is None:
                    out.append(len(self.example_at(split, i).audio))  # 16 kHz
                else:
                    frames, sr = n
                    # both resamplers emit floor(n·sr_out/sr_in) samples
                    out.append(frames if sr == 16000 else frames * 16000 // sr)
            _store_cached_lengths(path, out)
        cache[split] = out
        return out


def _wav_header_num_samples(path: str):
    """Back-compat alias: the RIFF header parser lives in ``native_audio``
    next to the WAV decoder (single home for container-format knowledge)."""
    from speech_transcript_embeddings_torch.data import native_audio
    return native_audio.wav_header_info(path)


def _resample_linear(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling via scipy (good quality, no librosa dependency).

    Output length is trimmed to floor(n·sr_out/sr_in) — the native
    ``ste_resample``'s length — so bucket assignment (and the exact-schedule
    length histogram, ``audio_lengths``) is identical whichever resampler ran;
    scipy's own ceil(n·up/down) can be one sample longer."""
    from math import gcd
    from scipy.signal import resample_poly
    g = gcd(sr_in, sr_out)
    out = resample_poly(wav, sr_out // g, sr_in // g).astype(np.float32)
    return out[: int(len(wav) * sr_out / sr_in)]


def make_source(cfg: DataConfig, seed: int = 1234):
    if cfg.dataset == "synthetic":
        return SyntheticSource(cfg, seed=seed)
    if cfg.dataset == "common_voice":
        return CommonVoiceSource(cfg)
    if cfg.dataset == "local":
        return LocalSource(cfg)
    raise ValueError(f"Unknown dataset {cfg.dataset!r}")
