"""Long-lived HTTP scoring service over ``InferencePipeline`` (the port of
the JAX package's root ``serve.py``).

The daemon keeps the model's weights resident on the card and serves scoring
requests over HTTP/JSON with cross-request microbatching: concurrent
clients' videos merge into shared bucket-routed (optionally sequence-packed)
batches, so the card sees production batch shapes even when each client
sends one video.

    python -m repurpose_tpu_torch.serve --config_path configs/repurpose.yaml --resume runs/full/ckpt
    python -m repurpose_tpu_torch.serve --torch_ckpt best.pth --pack --warmup
    python -m repurpose_tpu_torch.serve --config_path tiny.yaml --device cpu
    curl -s localhost:8976/healthz
    curl -s -X POST localhost:8976/score -d '{"videos": [{"video_id": "a",
        "visual": [[...]...], "audio": [[...]...], "text": [[...]...]}]}'

API:
- ``GET /healthz`` -> {"status": "ok", platform, card, buckets, pack,
  batch_size, queued, scored_total, uptime_s}.
- ``POST /score`` -> {"results": [...]} in request order; each result is the
  reference's result schema {video_id, segments, scores, labels, duration}
  JSON-encoded. Videos carry inline per-second features (``visual
  [T,vis_dim]``, ``audio [T,aud_dim]``, ``text [T,text_dim]`` float lists) or,
  with ``--feature_root DIR``, just a ``video_id`` resolved to
  ``DIR/{visual,audio,text}/{id}.npy``. A malformed request gets 400, an
  unknown path 404, a body of no or more than 1 GiB 413, a failed scoring
  call 500 and a request not scored within ``--request_timeout_s`` 503.

Design: one scorer thread owns all device work. Requests enqueue and block
on an event; the scorer drains the queue (the first video waits at most
``--max_wait_ms`` for company, bounded by ``--max_videos_per_batch``),
scores every pending video in one ``score_videos`` call and fans the results
back out. ``--warmup`` builds the CUDA kernels and scores every power-of-two
row count of every bucket before the readiness line, so that no request
waits on a kernel build or on cuBLAS's first call. Checkpoints resolve as in
``python -m repurpose_tpu_torch.inference`` (``--torch_ckpt``, ``--resume``,
or seeded random weights). ``--device`` defaults to ``cuda`` and raises
without a card. SIGTERM and SIGINT stop the server; ``main`` then returns 0.

``main(argv)`` loads the config from ``--config_path`` (YAML, or the same
schema as ``.json``, which needs no PyYAML); ``make_server(cfg, args)``
takes a ``Config`` built in Python and returns the server without serving.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from repurpose_tpu_torch import resolve_device
from repurpose_tpu_torch.config import Config, load_config
from repurpose_tpu_torch.infer import InferencePipeline
from repurpose_tpu_torch.inference import load_params

MAX_BODY_BYTES = 1 << 30


class _Scorer(threading.Thread):
    """Single device-owning thread: drains queued requests into one
    ``score_videos`` call and distributes the results."""

    def __init__(self, pipe, buckets, batch_size, pack, depth,
                 max_wait_s, max_videos, request_timeout_s=600.0):
        super().__init__(daemon=True, name="scorer")
        self.pipe = pipe
        self.buckets = tuple(buckets)
        self.batch_size = batch_size
        self.pack = pack
        self.depth = depth
        self.max_wait_s = max_wait_s
        self.max_videos = max_videos
        self.request_timeout_s = request_timeout_s
        self.q: queue.Queue = queue.Queue()
        self.scored_total = 0
        self._stopping = False

    def submit(self, videos: list, timeout: float) -> list:
        """Called from handler threads: enqueue, block until scored."""
        slot = {"videos": videos, "ev": threading.Event(),
                "results": None, "error": None}
        self.q.put(slot)
        if not slot["ev"].wait(timeout):
            raise TimeoutError("scoring timed out")
        if slot["error"] is not None:
            raise RuntimeError(slot["error"])
        return slot["results"]

    def stop(self) -> None:
        self._stopping = True
        self.q.put(None)

    def run(self) -> None:
        while not self._stopping:
            slot = self.q.get()
            if slot is None:
                break
            batch = [slot]
            n = len(slot["videos"])
            deadline = time.monotonic() + self.max_wait_s
            while n < self.max_videos:
                t = deadline - time.monotonic()
                if t <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=t)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stopping = True
                    break
                batch.append(nxt)
                n += len(nxt["videos"])
            videos = [v for s in batch for v in s["videos"]]
            try:
                results = self.pipe.score_videos(
                    videos, buckets=self.buckets, batch_size=self.batch_size,
                    depth=self.depth, pack=self.pack,
                )
                self.scored_total += len(videos)
            except Exception as e:  # fan the failure out, keep serving
                logging.exception("scoring failed")
                for s in batch:
                    s["error"] = f"{type(e).__name__}: {e}"
                    s["ev"].set()
                continue
            off = 0
            for s in batch:
                k = len(s["videos"])
                s["results"] = results[off : off + k]
                off += k
                s["ev"].set()


def _json_result(r: dict) -> dict:
    return {
        "video_id": str(r["video_id"]),
        "segments": np.asarray(r["segments"], np.float64).tolist(),
        "scores": np.asarray(r["scores"], np.float64).tolist(),
        "labels": np.asarray(r["labels"]).astype(int).tolist(),
        "duration": int(r["duration"]),
    }


def _make_handler(scorer: _Scorer, cfg: Config, feature_root, platform: str, card: str,
                  t0: float):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):  # route to logging, not stderr spam
            logging.debug("http: " + fmt, *a)

        def _reply(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") not in ("/healthz", ""):
                return self._reply(404, {"error": "unknown path"})
            self._reply(200, {
                "status": "ok",
                "platform": platform,
                "card": card,
                "buckets": list(scorer.buckets),
                "pack": scorer.pack,
                "batch_size": scorer.batch_size,
                "queued": scorer.q.qsize(),
                "scored_total": scorer.scored_total,
                "uptime_s": round(time.monotonic() - t0, 1),
            })

        def _load_video(self, v: dict, i: int) -> dict:
            if all(k in v for k in ("visual", "audio", "text")):
                return {
                    "video_id": str(v.get("video_id", i)),
                    "visual": np.asarray(v["visual"], np.float32),
                    "audio": np.asarray(v["audio"], np.float32),
                    "text": np.asarray(v["text"], np.float32),
                }
            if feature_root and "video_id" in v:
                vid = str(v["video_id"])
                if os.path.basename(vid) != vid:  # no path traversal
                    raise ValueError(f"bad video_id {vid!r}")
                out = {"video_id": vid}
                for mod in ("visual", "audio", "text"):
                    path = os.path.join(feature_root, mod, f"{vid}.npy")
                    out[mod] = np.load(path, allow_pickle=False).astype(np.float32)
                return out
            raise ValueError(
                f"video {i}: needs inline visual/audio/text features"
                + (" or a video_id under --feature_root" if feature_root
                   else " (start with --feature_root to serve by video_id)")
            )

        def do_POST(self):
            if self.path.rstrip("/") != "/score":
                # replying before draining the body would desync a keep-alive
                # connection (the unread body parses as the next request)
                self.close_connection = True
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                if not 0 < n <= MAX_BODY_BYTES:
                    self.close_connection = True
                    return self._reply(413, {"error": "bad request size"})
                req = json.loads(self.rfile.read(n))
                raw = req["videos"] if isinstance(req, dict) else req
                if not isinstance(raw, list) or not raw:
                    raise ValueError("'videos' must be a non-empty list")
                dims = (cfg.model.vis_dim, cfg.model.aud_dim, cfg.model.text_dim)
                videos = []
                for i, v in enumerate(raw):
                    lv = self._load_video(v, i)
                    for mod, d in zip(("visual", "audio", "text"), dims):
                        a = lv[mod]
                        if a.ndim != 2 or a.shape[1] != d or not len(a):
                            raise ValueError(
                                f"video {i} {mod}: expected [T>0, {d}], "
                                f"got {list(a.shape)}"
                            )
                    videos.append(lv)
            except Exception as e:  # any malformed request is the client's fault
                return self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            try:
                results = scorer.submit(videos, scorer.request_timeout_s)
            except TimeoutError as e:
                return self._reply(503, {"error": str(e)})
            except RuntimeError as e:  # the scorer's failure, fanned out
                return self._reply(500, {"error": str(e)})
            self._reply(200, {"results": [_json_result(r) for r in results]})

    return Handler


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m repurpose_tpu_torch.serve",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--config_path", default="configs/repurpose.yaml")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory of the port's trainer (<dir>/<step>.pt)")
    p.add_argument("--torch_ckpt", default=None, help="reference .pth checkpoint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8976)
    p.add_argument("--pack", action="store_true",
                   help="sequence-packed serving (the same results, less padding compute)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--depth", type=int, default=2,
                   help="host/device pipelining depth inside a drain")
    p.add_argument("--max_wait_ms", type=float, default=25.0,
                   help="how long the first queued video waits for company")
    p.add_argument("--max_videos_per_batch", type=int, default=64,
                   help="drain cap per scoring call (bounds tail latency)")
    p.add_argument("--request_timeout_s", type=float, default=600.0,
                   help="503 deadline per /score request")
    p.add_argument("--feature_root", default=None,
                   help="serve by video_id from DIR/{visual,audio,text}/*.npy")
    p.add_argument("--warmup", action="store_true",
                   help="build the kernels and score every bucket's row counts "
                        "before listening")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--log-level", default="INFO")
    return p.parse_args(argv)


def warmup(pipe: InferencePipeline, cfg: Config, buckets, batch_size: int,
           pack: bool) -> None:
    """Builds the kernels (on the card) and scores, per bucket, every
    power-of-two row count up to ``batch_size`` (a drain pads its rows to
    the smallest power of two >= its videos). Unpacked: n tiny videos make
    n rows. Packed: first-fit repacks tiny videos into one row, so just-over-
    half-bucket videos (one per row) make n rows."""
    if pipe.device.type == "cuda":
        from repurpose_tpu_torch import native

        t0 = time.perf_counter()
        native.build_all()
        logging.info("built the kernels in %.1fs", time.perf_counter() - t0)
    for b in buckets:
        t0 = time.perf_counter()
        t = (b // 2 + 8) if pack else min(b, 8)
        n = 1
        while n <= batch_size:
            pipe.score_videos(
                [{"video_id": f"warmup_{b}_{i}",
                  "visual": np.zeros((t, cfg.model.vis_dim), np.float32),
                  "audio": np.zeros((t, cfg.model.aud_dim), np.float32),
                  "text": np.zeros((t, cfg.model.text_dim), np.float32)}
                 for i in range(n)],
                buckets=(b,), batch_size=batch_size, pack=pack,
            )
            n *= 2
        logging.info("warmed bucket %d in %.1fs", b, time.perf_counter() - t0)


class _Server(ThreadingHTTPServer):
    # the default backlog (5) drops connections under concurrent-client
    # bursts while the scorer is mid-drain
    request_queue_size = 128
    daemon_threads = True


def make_server(cfg: Config, args: argparse.Namespace):
    """The daemon for ``cfg`` and the flags in ``args``, not yet serving:
    ``(server, scorer, platform, card)``. The scorer thread runs; the caller
    serves (``server.serve_forever()``) and stops both."""
    device = resolve_device(args.device)
    params = load_params(args, cfg)
    pipe = InferencePipeline(dataclasses.replace(cfg.model, dropout=0.0), params,
                             cfg.test_cfg, device=device)
    buckets = cfg.train.buckets
    if args.warmup:
        warmup(pipe, cfg, buckets, args.batch_size, args.pack)
    scorer = _Scorer(pipe, buckets, args.batch_size, args.pack, args.depth,
                     args.max_wait_ms / 1e3, args.max_videos_per_batch,
                     request_timeout_s=args.request_timeout_s)
    scorer.start()
    platform = device.type
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    server = _Server(
        (args.host, args.port),
        _make_handler(scorer, cfg, args.feature_root, platform, card, time.monotonic()),
    )
    return server, scorer, platform, card


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(),
                        format="%(asctime)s %(levelname)s %(message)s")
    resolve_device(args.device)  # no card: raise before the config is read
    cfg = load_config(args.config_path)
    server, scorer, platform, card = make_server(cfg, args)

    def shutdown(signum, frame):
        logging.info("signal %d: shutting down", signum)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    # readiness line on stdout: scripts and tests wait for it
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(platform={platform} {card}, buckets={list(cfg.train.buckets)}, "
          f"pack={args.pack})", flush=True)
    try:
        server.serve_forever()
    finally:
        scorer.stop()
        scorer.join(timeout=60)
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
