"""Embedding/similarity HTTP service over the port's ``Embedder``.

    python -m speech_transcript_embeddings_torch.serve \
        --checkpoint DIR --device cuda --port 8787 [--int8]

Endpoints (JSON in/out), as ``speech_transcript_embeddings_tpu.serve``
serves them:
  GET  /healthz            → {"status": "ok", "projection_dim": D}
  GET  /stats              → uptime + per-modality request counts, coalesced
                             batch sizes, latency p50/p95 (bounded windows)
  POST /embed_text         {"texts": [...]}                → {"embeddings": [[...]]}
  POST /embed_audio        {"audios": [[...]], "sample_rate": N} → {"embeddings": ...}
  POST /similarity         {"text": "...", "audio": [...], "sample_rate": N}
                           → {"similarity": s, "similarity_fused": f}

Concurrent requests coalesce into one device batch (``MicroBatcher``); only
the device call itself holds the device lock. ``MicroBatcher``,
``EmbeddingService``'s request methods and ``make_handler`` are the port's
copy of that module's (stdlib and numpy only): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class _Future:
    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error = None

    def set(self, value):
        self._value = value
        self._event.set()

    def set_error(self, err):
        self._error = err
        self._event.set()

    def result(self):
        self._event.wait()
        if self._error is not None:
            raise self._error
        return self._value


class MicroBatcher:
    """Request-coalescing queue in front of a batched embed function.

    Concurrent ``submit`` calls are merged into one device batch: the dispatch
    thread takes the first pending request, drains whatever else is ALREADY
    queued (up to ``max_batch`` rows), runs ``fn`` once under the shared
    device lock, and fans results back out. A lone request on an idle server
    dispatches immediately — no artificial wait; coalescing emerges under
    load, where requests pile up while the device is busy with the previous
    batch. ``window_s`` is an optional extra wait for stragglers, applied
    ONLY when the initial drain already found a second request (i.e. the
    server is demonstrably under concurrent load).
    """

    def __init__(self, fn, device_lock: threading.Lock,
                 max_batch: int = 64, window_s: float = 0.003):
        import collections
        self.fn = fn
        self.device_lock = device_lock
        self.max_batch = max_batch
        self.window_s = window_s
        # telemetry: bounded deques — a long-lived server must not grow lists
        # forever; counters under a lock (ints shared across handler threads)
        self.batch_sizes = collections.deque(maxlen=1024)
        self.latencies_ms = collections.deque(maxlen=1024)
        self._stats_lock = threading.Lock()
        self.requests = 0
        self.items_total = 0
        self.dispatches = 0
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, items: list):
        t0 = time.monotonic()
        fut = _Future()
        self._q.put((list(items), fut))
        out = fut.result()
        with self._stats_lock:
            self.requests += 1
            self.items_total += len(items)
            self.latencies_ms.append((time.monotonic() - t0) * 1e3)
        return out

    def stats(self) -> dict:
        """Bounded-window service telemetry for the /stats endpoint."""
        with self._stats_lock:
            lats = sorted(self.latencies_ms)
            sizes = list(self.batch_sizes)
            d = {"requests": self.requests, "items": self.items_total,
                 "dispatches": self.dispatches}
        if lats:
            pick = lambda q: lats[min(int(q * len(lats)), len(lats) - 1)]
            d["latency_ms"] = {"p50": round(pick(0.50), 2),
                               "p95": round(pick(0.95), 2),
                               "max": round(lats[-1], 2)}
        if sizes:
            d["coalesced_batch"] = {
                "mean": round(sum(sizes) / len(sizes), 2), "max": max(sizes)}
        return d

    def _drain(self, pending, total, deadline=None):
        while total < self.max_batch:
            try:
                if deadline is None:
                    items, fut = self._q.get_nowait()
                else:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    items, fut = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            pending.append((items, fut))
            total += len(items)
        return total

    def _collect(self):
        items, fut = self._q.get()
        pending = [(items, fut)]
        total = self._drain(pending, len(items))
        if len(pending) > 1 and total < self.max_batch and self.window_s > 0:
            # concurrent load detected: briefly wait for stragglers
            self._drain(pending, total,
                        deadline=time.monotonic() + self.window_s)
        return pending

    def _run(self):
        while True:
            pending = self._collect()
            merged = [it for items, _ in pending for it in items]
            with self._stats_lock:
                self.dispatches += 1
                self.batch_sizes.append(len(merged))
            try:
                with self.device_lock:
                    out = self.fn(merged)
            except Exception as e:                  # fan the error out
                for _, fut in pending:
                    fut.set_error(e)
                continue
            off = 0
            for items, fut in pending:
                fut.set(out[off:off + len(items)])
                off += len(items)


class EmbeddingService:
    """The request methods over the port's ``Embedder`` on ``device``."""

    def __init__(self, checkpoint: str, device: str = "cuda",
                 max_batch: int = 64, window_ms: float = 3.0,
                 int8: bool = False):
        from speech_transcript_embeddings_torch.inference.embed import Embedder
        self.embedder = Embedder.from_checkpoint(checkpoint, device=device)
        if int8:
            # dynamic W8A8 Dense products (ops/quant.py): int8 weights, half
            # the bytes of the bf16 Dense weights
            self.embedder.quantize_int8()
        self._started = time.monotonic()
        self._lock = threading.Lock()
        self._text_batcher = MicroBatcher(
            self.embedder.embed_texts, self._lock,
            max_batch=max_batch, window_s=window_ms / 1000.0)
        self._audio_batcher = MicroBatcher(
            self.embedder.embed_audios, self._lock,
            max_batch=max_batch, window_s=window_ms / 1000.0)

    def _prep_audio(self, audio, sample_rate):
        wav = np.asarray(audio, np.float32)
        if sample_rate and sample_rate != 16000:
            from speech_transcript_embeddings_torch.data import native_audio
            wav = native_audio.resample(wav, int(sample_rate), 16000)
        return wav

    def embed_text(self, texts):
        return self._text_batcher.submit(list(texts)).tolist()

    def embed_audio(self, audios, sample_rate=16000):
        wavs = [self._prep_audio(a, sample_rate) for a in audios]
        return self._audio_batcher.submit(wavs).tolist()

    def similarity(self, text, audio, sample_rate=16000):
        wav = self._prep_audio(audio, sample_rate)
        te = self._text_batcher.submit([text])[0]
        ae = self._audio_batcher.submit([wav])[0]
        with self._lock:
            fused, _, _ = self.embedder.embed_pair(text, wav)
        return {"similarity": float(np.dot(te, ae)),
                "similarity_fused": float(fused)}

    def stats(self) -> dict:
        return {"uptime_s": round(time.monotonic() - self._started, 1),
                "text": self._text_batcher.stats(),
                "audio": self._audio_batcher.stats()}


def make_handler(service: EmbeddingService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):   # quiet by default
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "projection_dim": service.embedder.cfg.model.heads.projection_dim,
                })
            elif self.path == "/stats":
                self._send(200, service.stats())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/embed_text":
                    if not isinstance(req.get("texts"), list) or not req["texts"]:
                        return self._send(400, {"error": "texts: non-empty list required"})
                    return self._send(200, {"embeddings": service.embed_text(req["texts"])})
                if self.path == "/embed_audio":
                    if not isinstance(req.get("audios"), list) or not req["audios"]:
                        return self._send(400, {"error": "audios: non-empty list required"})
                    return self._send(200, {"embeddings": service.embed_audio(
                        req["audios"], req.get("sample_rate", 16000))})
                if self.path == "/similarity":
                    if "text" not in req or "audio" not in req:
                        return self._send(400, {"error": "text and audio required"})
                    return self._send(200, service.similarity(
                        req["text"], req["audio"], req.get("sample_rate", 16000)))
                return self._send(404, {"error": f"unknown path {self.path}"})
            except json.JSONDecodeError:
                self._send(400, {"error": "invalid JSON body"})
            except Exception as e:                       # surface, don't crash
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


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
                   help="int8 (W8A8) Dense products")
    args = p.parse_args(argv)
    serve(args.checkpoint, args.host, args.port, device=args.device,
          int8=args.int8)


if __name__ == "__main__":
    main()
