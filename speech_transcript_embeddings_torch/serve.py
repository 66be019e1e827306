"""Embedding/similarity HTTP service over the port's ``Embedder``.

    python -m speech_transcript_embeddings_torch.serve \
        --checkpoint DIR --device cuda --port 8787

The same endpoints as ``speech_transcript_embeddings_tpu.serve`` (``GET
/healthz``, ``GET /stats``, ``POST /embed_text``, ``/embed_audio``,
``/similarity``), served by that module's ``EmbeddingService`` request
methods, ``MicroBatcher`` (concurrent requests coalesce into one device
batch) and ``make_handler``, imported rather than copied: they are
framework-free.
"""

from __future__ import annotations

import argparse
import threading
import time
from http.server import ThreadingHTTPServer

from speech_transcript_embeddings_tpu import serve as tpu_serve
from speech_transcript_embeddings_tpu.serve import MicroBatcher, make_handler


class EmbeddingService(tpu_serve.EmbeddingService):
    """The JAX package's service (its request methods are framework-free)
    over the port's ``Embedder`` on ``device``."""

    def __init__(self, checkpoint: str, device: str = "cuda",
                 max_batch: int = 64, window_ms: float = 3.0,
                 int8: bool = False):
        if int8:
            raise NotImplementedError(
                "--int8 is not yet ported (ops/quant.py; ROADMAP.md, Queue 1)")
        from speech_transcript_embeddings_torch.inference.embed import Embedder
        self.embedder = Embedder.from_checkpoint(checkpoint, device=device)
        self._started = time.monotonic()
        self._lock = threading.Lock()
        self._text_batcher = MicroBatcher(
            self.embedder.embed_texts, self._lock,
            max_batch=max_batch, window_s=window_ms / 1000.0)
        self._audio_batcher = MicroBatcher(
            self.embedder.embed_audios, self._lock,
            max_batch=max_batch, window_s=window_ms / 1000.0)


def serve(checkpoint: str, host: str = "127.0.0.1", port: int = 8787,
          device: str = "cuda", int8: bool = False):
    service = EmbeddingService(checkpoint, device=device, int8=int8)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    print(f"serving embeddings from {checkpoint} on {device} at "
          f"http://{host}:{server.server_port}")
    server.serve_forever()


def main(argv=None):
    p = argparse.ArgumentParser(description="Embedding HTTP service (PyTorch)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--device", default="cuda")
    p.add_argument("--int8", action="store_true",
                   help="int8 serving (not yet ported: raises)")
    args = p.parse_args(argv)
    serve(args.checkpoint, args.host, args.port, device=args.device,
          int8=args.int8)


if __name__ == "__main__":
    main()
