"""VQA serving: an HTTP endpoint over micro-batched, bucketed generation on the card.

Counterpart of ``projectiontrainer_tpu/cli/serve.py``:

- requests queue up; the PREFIX worker drains up to ``--batch_size`` of them (adaptive
  fill: while the decode stage is busy, filling costs nothing, so it keeps topping up;
  ``--max_wait_ms`` bounds the wait only once the pipeline would otherwise starve),
  pads stragglers to the batch shape and enqueues the [visual; question] prefix;
- the DECODE worker beam-decodes the previous batch and detokenizes it;
- a depth-1 handoff keeps at most two batches in flight.

Both workers enqueue on the default CUDA stream, so the card runs their work in
enqueue order and no events are needed; overlapping them on side streams is later
work. The service can be built from snapshot paths (``args``) or from a model
already in memory (``model=(vlm_cfg, params, tokenizer)``); either way
``--adapter_path`` merges a LoRA adapter into the decoder first.

Endpoints:
  POST /v1/vqa   {"image": <base64 jpeg/png> | "image_path": <server path>,
                  "question": str}          -> {"answer": str, "latency_ms": float}
  GET  /healthz  liveness and the torch device
  GET  /stats    request count, p50/p95 latency, batch count and mean batch size
"""

from __future__ import annotations

import base64
import io
import json
import os
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from projectiontrainer_tpu_torch.cli import infer_vqa_stage2 as vqa
from projectiontrainer_tpu_torch.data.bucketing import DEFAULT_Q_BUCKETS, buckets_covering
from projectiontrainer_tpu_torch.utils.logging import setup_logging


def build_parser():
    p = vqa.build_parser()
    p.description = __doc__
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--request_timeout_s", type=float, default=900.0,
                   help="per-request wait bound")
    p.add_argument("--max_wait_ms", type=float, default=20.0,
                   help="How long the batcher waits for a batch to fill")
    p.add_argument("--warmup", action="store_true",
                   help="Run one batch per question bucket at startup (builds the kernels)")
    return p


class _LockedTokenizer:
    """HF fast tokenizers are not re-entrant: handler threads encode while the decode
    worker decodes."""

    def __init__(self, tok):
        self._tok = tok
        self._lock = threading.Lock()
        self.pad_token_id = tok.pad_token_id
        self.eos_token_id = tok.eos_token_id

    def __call__(self, *a, **kw):
        with self._lock:
            return self._tok(*a, **kw)

    def decode(self, *a, **kw):
        with self._lock:
            return self._tok.decode(*a, **kw)


class Request:
    __slots__ = ("pixels", "q_ids", "event", "answer", "error", "t_enqueue", "abandoned")

    def __init__(self, pixels, q_ids):
        self.pixels = pixels          # [H, W, C] float32, preprocessed
        self.q_ids = q_ids            # list[int] question token ids (no specials)
        self.event = threading.Event()
        self.answer = None
        self.error = None
        self.t_enqueue = time.perf_counter()
        self.abandoned = False        # the waiter timed out: do not compute for nobody


class VQAService:
    """Owns the model and the two micro-batching workers."""

    def __init__(self, args, logger, model=None):
        """``model``: an already built ``(vlm_cfg, params, tokenizer)``; None builds it
        from ``args`` (snapshot paths, ``--device``). ``--adapter_path`` merges into a
        copy of the model's decoder tree (the given params are not changed)."""
        vqa.check_adapter(args)
        self.args = args
        self.logger = logger
        if model is None:
            from projectiontrainer_tpu_torch.train import setup

            vlm_cfg, params = setup.build_vlm(
                args.vision_model_name, args.llm_name, device=torch.device(args.device),
                stage1_projector_path=args.projector_path)
            model = (vlm_cfg, params, setup.load_tokenizer(args.llm_name))
        self.vlm_cfg, params, tokenizer = model
        self.params = dict(params)
        vqa.merge_adapter(args, self.params, logger)
        self.device = self.params["llm"]["embed_tokens"]["embedding"].device
        self.tokenizer = _LockedTokenizer(tokenizer)
        self.gen_cfg = vqa.generation_config(args, self.tokenizer)
        self.pad = self.tokenizer.pad_token_id or 0
        self.buckets = buckets_covering(args.max_q_len, DEFAULT_Q_BUCKETS)
        self.queue: queue.Queue = queue.Queue()
        self.latencies = deque(maxlen=65536)  # bounded: a long-lived server
        self.batch_sizes = deque(maxlen=8192)
        self._lock = threading.Lock()
        self.prefix_queue: queue.Queue = queue.Queue(maxsize=1)  # <= 2 batches in flight
        self._decode_busy = threading.Event()  # the batcher's "filling is free" signal
        self.prefix_worker = threading.Thread(target=self._prefix_worker, daemon=True)
        self.decode_worker = threading.Thread(target=self._decode_worker, daemon=True)
        self.prefix_worker.start()
        self.decode_worker.start()

    # ---------------------------------------------------------------- request prep

    def preprocess(self, body: dict) -> Request:
        from projectiontrainer_tpu_torch.data import image as I  # PIL: image intake only

        if "image" in body:
            from PIL import Image

            img = Image.open(io.BytesIO(base64.b64decode(body["image"]))).convert("RGB")
        elif "image_path" in body:
            path = body["image_path"]
            if not os.path.isabs(path):
                if not self.args.image_root:
                    raise ValueError(
                        "relative image_path needs the server started with --image_root")
                path = I.resolve_image_path(path, self.args.image_root, self.args.image_root_2)
            img = I.load_image(path)
        else:
            raise ValueError("request needs 'image' (base64) or 'image_path'")
        pixels = I.preprocess(img, self.args.img_size)
        q_ids = self.tokenizer(body.get("question", "Describe the findings."),
                               max_length=self.args.max_q_len, truncation=True,
                               add_special_tokens=False)["input_ids"]
        return Request(pixels, q_ids)

    def submit(self, req: Request, timeout_s: float | None = None) -> str:
        if timeout_s is None:
            timeout_s = self.args.request_timeout_s
        self.queue.put(req)
        if not req.event.wait(timeout_s):
            req.abandoned = True
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.answer

    # ---------------------------------------------------------------- workers

    def _drain_batch(self) -> list[Request]:
        while True:
            first = self.queue.get()
            if first is None:  # shutdown sentinel
                return []
            if not first.abandoned:
                break
        batch = [first]
        deadline = time.perf_counter() + self.args.max_wait_ms / 1e3
        while len(batch) < self.args.batch_size:
            now = time.perf_counter()
            pipeline_busy = self._decode_busy.is_set() or not self.prefix_queue.empty()
            if pipeline_busy:
                deadline = now + self.args.max_wait_ms / 1e3
            elif now >= deadline:
                break
            try:
                nxt = self.queue.get(timeout=0.005 if pipeline_busy else max(0.0, deadline - now))
            except queue.Empty:
                continue
            if nxt is None:
                self.queue.put(None)  # re-post for the outer loop to see
                break
            if not nxt.abandoned:
                batch.append(nxt)
        return batch

    def _build_prefix(self, batch: list[Request]):
        """Straggler-pad to the batch shape, then enqueue the prefix (the batch CLI's
        code path)."""
        bsz, n_real = self.args.batch_size, len(batch)
        pixels = np.stack([r.pixels for r in batch] + [batch[-1].pixels] * (bsz - n_real))
        q_tok = [r.q_ids for r in batch] + [batch[-1].q_ids] * (bsz - n_real)
        return vqa.build_prefix(pixels, q_tok, self.vlm_cfg, self.params, self.tokenizer,
                                max_q_len=self.args.max_q_len)

    def _run_batch(self, batch: list[Request]) -> list[str]:
        embeds, mask = self._build_prefix(batch)
        return vqa.decode_prefix(embeds, mask, self.vlm_cfg, self.params, self.tokenizer,
                                 gen_cfg=self.gen_cfg)[:len(batch)]

    def _prefix_worker(self):
        """Stage A: drain a micro-batch, enqueue its prefix, hand it to stage B."""
        while True:
            batch = self._drain_batch()
            if not batch:
                self.prefix_queue.put(None)  # propagate shutdown
                return
            try:
                embeds, mask = self._build_prefix(batch)
                self.prefix_queue.put((batch, embeds, mask))
            except Exception as e:  # a bad batch must not kill the pipeline
                self.logger.exception("prefix build failed")
                for r in batch:
                    r.error = e
                    r.event.set()

    def _decode_worker(self):
        """Stage B: beam decode from the prebuilt prefix and detokenize."""
        while True:
            item = self.prefix_queue.get()
            if item is None:
                return
            batch, embeds, mask = item
            self._decode_busy.set()
            try:
                answers = vqa.decode_prefix(embeds, mask, self.vlm_cfg, self.params,
                                            self.tokenizer, gen_cfg=self.gen_cfg)
                now = time.perf_counter()
                with self._lock:
                    self.batch_sizes.append(len(batch))
                    self.latencies.extend(now - r.t_enqueue for r in batch)
                for r, a in zip(batch, answers):
                    r.answer = a
                    r.event.set()
            except Exception as e:  # surface the failure to every waiter
                self.logger.exception("batch failed")
                for r in batch:
                    r.error = e
                    r.event.set()
            finally:
                self._decode_busy.clear()

    def warmup(self):
        """One batch per (clamped) question bucket before traffic: builds the kernels
        and warms the allocator at every prefix shape."""
        blank = np.zeros((self.args.img_size, self.args.img_size, 3), np.float32)
        for q_len in sorted({min(b, self.args.max_q_len) for b in self.buckets}):
            self._run_batch([Request(blank, [self.pad] * q_len)
                             for _ in range(self.args.batch_size)])
            self.logger.info("warmed bucket q=%d batch=%d", q_len, self.args.batch_size)

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self.latencies)
            sizes = list(self.batch_sizes)
        pct = lambda p: lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0
        return {
            "requests": len(lat),
            "p50_latency_s": pct(0.50),
            "p95_latency_s": pct(0.95),
            "batches": len(sizes),
            "mean_batch_size": float(np.mean(sizes)) if sizes else 0.0,
        }

    def shutdown(self, timeout_s: float = 60.0):
        """Stop both workers after the batches already queued, and wait for them."""
        self.queue.put(None)
        self.prefix_worker.join(timeout_s)
        self.decode_worker.join(timeout_s)


def make_server(service: VQAService, host: str, port: int):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                dev = service.device
                name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
                self._reply(200, {"ok": True, "device": str(dev), "device_name": name})
            elif self.path == "/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/v1/vqa":
                self._reply(404, {"error": "unknown path"})
                return
            # caller errors -> 400; generation failures and timeouts -> 500
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = service.preprocess(json.loads(self.rfile.read(length) or b"{}"))
            except Exception as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                t0 = time.perf_counter()
                answer = service.submit(req)
                self._reply(200, {"answer": answer,
                                  "latency_ms": (time.perf_counter() - t0) * 1e3})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *fmt_args):
            service.logger.debug("http: " + fmt, *fmt_args)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    args = build_parser().parse_args(argv)
    logger = setup_logging()
    service = VQAService(args, logger)
    if args.warmup:
        service.warmup()
    server = make_server(service, args.host, args.port)
    logger.info("serving VQA on http://%s:%d (batch=%d, wait=%.0fms, device=%s)",
                args.host, args.port, args.batch_size, args.max_wait_ms, service.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.shutdown()
        server.server_close()
    return server


if __name__ == "__main__":
    main()
