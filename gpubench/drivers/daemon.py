"""Driver of the serving cells: the port's HTTP daemon
(``repurpose_tpu_torch.serve.make_server``) in the run's own process,
driven by closed-loop clients over HTTP on ``127.0.0.1``.

Set-up writes the workload's pool of videos as ``.npy`` files (the
daemon's ``--feature_root``), builds the daemon with the workload's flags,
loads the benchmark's weights into it and starts the load: closed-loop
clients in one process of their own (``gpubench/load.py``), run until the
warm-up requests are answered: the shapes the traffic uses, nothing else.
The clients keep going through the window; each sends its next request
when its reply arrives, of a size drawn from the workload. After the
window every reply is judged against the plain reference's outputs for
its videos (``gpubench/reference/serve.py``).

Workload keys: ``daemon``, the daemon's flags (``pack``, ``batch_size``,
``depth``, ``max_wait_ms``, ``max_videos_per_batch``);
``traffic``: ``pool`` (videos), ``lengths`` (a ``gpubench.traffic`` spec),
``clients``, ``videos_per_request`` [lo, hi], ``warmup_requests``;
``heads`` (the served model's heads' law, ``gpubench/weights.py``);
``trace``: ``min_replies``, ``min_seconds``; ``limits``.
"""

from __future__ import annotations

import json
import multiprocessing
import shutil
import threading
import time
from dataclasses import dataclass, field

from gpubench import common, traffic
from gpubench.load import run_load
from gpubench.reference import serve as ref_serve
from gpubench.trace import Stretch
from gpubench.weights import served_weights


@dataclass
class Request:
    sent: float
    done: float
    ids: list[str]
    ok: bool
    results: list = field(default_factory=list)


def run(ctx) -> dict:
    from repurpose_tpu_torch import serve

    wl, raw, dev = ctx.workload, ctx.config, ctx.device
    tw, m = wl["traffic"], raw["model"]
    cfg = common.program_config(raw, ctx.seed)
    shutil.rmtree(ctx.scratch, ignore_errors=True)
    lengths = traffic.durations(tw["lengths"], tw["pool"], ctx.seed)
    dims = {"visual": m["vis_dim"], "audio": m["aud_dim"], "text": m["text_dim"]}
    pool = traffic.write_corpus(str(ctx.scratch / "pool"), lengths, dims, ctx.seed, dev)
    rows_of = {e["youtube_id"]: d + 1 for e, d in zip(pool["entries"], lengths)}
    ctx.say(f"pool: {len(lengths)} videos, {pool['bytes']} bytes of features, "
            f"written by {time.time() - ctx.t_start:.3f} s")

    flags = wl["daemon"]
    argv = ["--feature_root", pool["root"], "--port", "0", "--device", str(dev),
            "--batch_size", str(flags["batch_size"]), "--depth", str(flags["depth"]),
            "--max_wait_ms", str(flags["max_wait_ms"]),
            "--max_videos_per_batch", str(flags["max_videos_per_batch"])]
    args = serve.parse_args(argv + (["--pack"] if flags["pack"] else []))
    server, scorer, _, _ = serve.make_server(cfg, args)
    first = pool["entries"][0]["youtube_id"]
    weights = served_weights(m, ctx.seed, dev, wl["heads"], traffic.load_features(pool, first))
    scorer.pipe.model.load_state_dict(weights, strict=True)
    weights = {k: v.cpu() for k, v in weights.items()}  # the reference's, after the window
    ctx.say(f"daemon built, weights loaded by {time.time() - ctx.t_start:.3f} s")
    serving = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                               daemon=True)
    serving.start()
    mp = multiprocessing.get_context("spawn")
    replies, stop, out = mp.Value("l", 0), mp.Event(), mp.Queue()
    load = mp.Process(target=run_load, args=(server.server_address[1], sorted(rows_of),
                                             tw["clients"], tw["videos_per_request"], ctx.seed,
                                             replies, stop, out))
    load.start()
    try:
        while replies.value < tw["warmup_requests"]:
            time.sleep(0.01)
        stretch = trace = span = None
        if ctx.trace:  # the profiler's start-up before the window
            stretch = Stretch("serve")
            stretch.start()
        common.sync(dev)
        common.reset_peak(dev)
        t0 = time.perf_counter()
        setup_s = time.time() - ctx.t_start
        span, at_span = [t0, None], replies.value
        t1 = t0 + ctx.seconds
        while time.perf_counter() < t1:
            time.sleep(0.005)
            if stretch is not None and replies.value - at_span >= wl["trace"]["min_replies"] \
                    and time.perf_counter() - t0 >= wl["trace"]["min_seconds"]:
                trace = stretch.stop()
                span[1] = time.perf_counter()
                stretch = None
        if stretch is not None:
            trace = stretch.stop()
            span[1] = time.perf_counter()
        stop.set()
        records, finished = out.get(timeout=300)
        memory_peak = common.peak_bytes(dev)
    finally:
        stop.set()
        load.join(60)
        if load.is_alive():
            load.kill()
            load.join()
        server.shutdown()
        scorer.stop()
        scorer.join(60)
        server.server_close()
        serving.join(10)
    del scorer, server
    common.free_device()

    records = [Request(*r) for r in records]
    window = [r for r in records if t0 <= r.sent < t1]
    answered = [r for r in records if r.ok and t0 <= r.done <= t1]
    videos = sum(len(r.ids) for r in answered)
    latencies = [(r.done - r.sent) if r.ok else float("inf") for r in window]
    failed = sum(not r.ok for r in window)
    ctx.say(f"requests in the window: {len(window)} ({failed} failed), "
            f"{len(answered)} answered in it, {videos} videos")
    ctx.say(f"serve_p95_ms over {len(latencies)} requests; "
            f"median {1e3 * common.percentile(latencies, 50):.3f} ms")

    reader = {"kind": "serve"}
    if ctx.trace:
        done = [r for r in records if r.ok and span[0] <= r.done <= span[1]]
        reader.update(videos=sum(len(r.ids) for r in done),
                      lengths=[rows_of[i] for r in done for i in r.ids])
        ctx.say(f"traced: {len(done)} replies, {reader['videos']} videos")

    # the comparison: every reply of the window against the reference
    weights = {k: v.to(dev) for k, v in weights.items()}
    needed = sorted({i for r in window if r.ok for i in r.ids})
    reference = {i: ref_serve.outputs(weights, m, traffic.load_features(pool, i), dev)
                 for i in needed}
    del weights
    results, sound = [], finished
    for r in window:
        if r.ok:
            sound &= [x["video_id"] for x in r.results] == r.ids
            results += r.results
    gaps, wrong = ref_serve.judge(results, reference, raw["test_cfg"])
    sound &= wrong == 0
    ctx.say(f"judged {len(results)} served videos, {sum(len(x['labels']) for x in results)} "
            f"clips; {wrong} with a wrong duration; gaps {json.dumps(gaps)}")
    shutil.rmtree(ctx.scratch, ignore_errors=True)
    limits = wl["limits"]
    return {
        "e2e": {"serve_videos_per_s": videos / (t1 - t0),
                "serve_p95_ms": 1e3 * common.percentile(latencies, 95),
                "setup_s": setup_s},
        "attempted": len(window), "failed": failed,
        "compared": {k: gaps[k] for k in limits}, "limits": limits, "sound": sound,
        "memory_peak_bytes": memory_peak, "trace": trace, "reader": reader,
    }
