# The port's copy of speech_transcript_embeddings_tpu/utils/env.py: the port imports
# nothing of the JAX package. Keep the two in step.
"""Minimal ``.env`` loader for CLI entry points.

The reference loads a ``.env`` via python-dotenv so the HF token needn't live
in the shell (trainer_unfreeze.py:31-32,47 — ``load_dotenv()`` then
``os.environ['HF_TOKEN']``). python-dotenv isn't a dependency here; this is
the same convenience in ~20 lines: ``KEY=VALUE`` lines (optional ``export ``
prefix, ``#`` comments, single/double quotes stripped), applied to
``os.environ`` without overriding variables the shell already set.
"""

from __future__ import annotations

import os


def load_dotenv(path: str = ".env") -> dict:
    """Load ``path`` into os.environ (existing vars win). → the parsed dict."""
    out: dict = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            if line.startswith("export "):
                line = line[len("export "):]
            key, _, val = line.partition("=")
            key = key.strip()
            val = val.strip()
            if len(val) >= 2 and val[0] == val[-1] and val[0] in "'\"":
                val = val[1:-1]
            if key:
                out[key] = val
                os.environ.setdefault(key, val)
    # the HF hub reads HF_TOKEN from the env; nothing else to wire
    return out
