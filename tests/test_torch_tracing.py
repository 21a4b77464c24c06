"""The port's recorder (``repurpose_tpu_torch/utils/profiling.py``) and the
spans it takes, on the CPU:

- outside a profiler nothing is recorded and ``span`` is one shared no-op,
  with no clock read and no ``record_function``;
- inside ``torch.profiler.profile`` each span's ``record_function`` copy
  lies between its recorded start and end (the two clocks agree to 20 us);
- the serving daemon under the profiler with concurrent clients: one
  ``serve.queue_wait`` and one ``serve.intake`` per request, and drains
  whose counts sum to the videos scored, as ``/healthz`` counts them;
- ``BatchLoader.epoch``: one ``loader.wait`` per batch taken (and one for
  the end of an epoch run to its end), one ``loader.load`` per batch built;
- ``device_span`` records nothing on the CPU.
"""

import itertools
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repurpose_tpu_torch import serve
from repurpose_tpu_torch.config import ModelConfig, load_config
from repurpose_tpu_torch.data.loader import BatchLoader
from repurpose_tpu_torch.data.synthetic import SyntheticDataset
from repurpose_tpu_torch.utils import profiling

SLACK_NS = 20_000

TINY = {
    "train_dataset": {"label_path": "d.json", "video_path": "v", "audio_path": "a",
                      "text_path": "t"},
    "model": {"vis_dim": 8, "aud_dim": 12, "text_dim": 6, "d_model": 32,
              "self_num_layers": 1, "num_heads": 2},
    "train": {"seed": 11, "batch_size": 2},
    "test_cfg": {"pre_nms_topk": 16, "pre_nms_thresh": 0.2, "duration_thresh": 1,
                 "duration_thresh_max": 90, "max_seg_per_min": 2.0, "nms_sigma": 0.5,
                 "min_score": 0.01},
    "tpu": {"buckets": [64, 128], "compute_dtype": "float32", "attention_impl": "xla",
            "matmul_precision": "highest"},
}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _named(recs, name):
    return [r for r in recs if r.name == name]


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    profiling.clear()
    monkeypatch.setattr(profiling.time, "time_ns", lambda: pytest.fail("clock read"))
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: pytest.fail("record_function"))
    assert profiling.span("a") is profiling.span("b", videos=3) is profiling._OFF
    assert profiling.device_span("c", torch.zeros(1)) is profiling._OFF
    with profiling.span("a") as s:
        assert s is None
    assert profiling.stamp() is None
    profiling.waited("w", None)
    assert profiling.records() == []


def test_spans_bracket_their_record_function_copies():
    profiling.clear()
    with _cpu_profile() as prof:
        for i in range(20):
            with profiling.span(f"test.outer{i}", i=i):
                with profiling.annotate(f"test.inner{i}"):
                    torch.ones(64).sum()

        def on_a_thread():
            with profiling.span("test.thread"):
                pass

        t = threading.Thread(target=on_a_thread)
        t.start()
        t.join(30)
    recs = {r.name: r for r in profiling.records()}
    assert len(recs) == 41
    assert recs["test.outer3"].ids == {"i": 3}
    assert recs["test.thread"].thread != threading.get_ident()
    seen = 0
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()  # a span's is prefixed, an annotation's bare
        if not name.removeprefix("repurpose:").startswith("test."):
            continue  # (this profiler records the main thread's alone)
        r = recs[name.removeprefix("repurpose:")]
        assert name.startswith("repurpose:") == ("outer" in name)
        start = ev.start_ns()
        end = start + ev.duration_ns()
        assert r.start_ns - SLACK_NS <= start <= end <= r.end_ns + SLACK_NS, (name, r)
        seen += 1
    assert seen == 40
    with _cpu_profile():
        pass
    assert len(profiling.records()) == 41  # records outlive the session
    profiling.clear()
    assert profiling.records() == []


def test_device_span_records_nothing_on_the_cpu():
    profiling.clear()
    with _cpu_profile():
        with profiling.device_span("attention", torch.zeros(2)) as s:
            assert s is None
    assert profiling.records() == []


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("pack", [False, True])
def test_daemon_records_each_request_and_drain(tmp_path, pack):
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(TINY))
    argv = ["--port", "0", "--device", "cpu", "--batch_size", "2", "--max_wait_ms", "50"]
    args = serve.parse_args(argv + ["--pack"] * pack)
    server, scorer, _, _ = serve.make_server(load_config(str(cfg_path)), args)
    serving = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                               daemon=True)
    serving.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(3)
    clients = [[{"video_id": f"c{c}v{i}",
                 **{k: rng.normal(size=(t, d)).tolist()
                    for k, d in (("visual", 8), ("audio", 12), ("text", 6))}}
                for i, t in enumerate((17 + 13 * c, 90 - 7 * c, 40)[: 1 + c % 3])]
               for c in range(6)]
    out = {}
    try:
        before = _get(base + "/healthz")
        profiling.clear()
        with _cpu_profile():
            threads = [threading.Thread(target=lambda c=c: out.__setitem__(
                c, _post(base + "/score", {"videos": clients[c]}))) for c in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
        after = _get(base + "/healthz")
    finally:
        server.shutdown()
        scorer.stop()
        scorer.join(30)
        server.server_close()
        serving.join(30)
    assert not scorer.is_alive() and not serving.is_alive()
    assert sorted(out) == list(range(6))
    recs = profiling.records()
    videos = sum(len(c) for c in clients)
    assert len(_named(recs, "serve.queue_wait")) == len(clients)
    intake = _named(recs, "serve.intake")
    assert sorted(r.ids["videos"] for r in intake) == sorted(len(c) for c in clients)
    drains = _named(recs, "serve.drain")
    assert sum(r.ids["videos"] for r in drains) == videos
    assert after["drains_total"] - before["drains_total"] == len(drains)
    assert after["scored_total"] - before["scored_total"] == videos
    built = _named(recs, "infer.batch_build")
    decoded = _named(recs, "infer.decode")
    assert sum(r.ids["videos"] for r in built) == sum(r.ids["videos"] for r in decoded) == videos
    assert len(_named(recs, "serve.reply")) == len(clients)
    assert len(_named(recs, "infer.readback")) == len(_named(recs, "infer.forward")) \
        == len(decoded) >= len(drains)
    assert len(_named(recs, "infer.stage")) >= 5 * len(decoded)  # features, mask, durations
    for w in _named(recs, "serve.queue_wait"):  # each wait ends where its drain starts
        assert any(abs(d.start_ns - w.end_ns) < 50_000_000 for d in drains)


@pytest.mark.parametrize("pack", [False, True])
def test_loader_records_its_waits_and_loads(pack):
    cfg = ModelConfig(vis_dim=8, aud_dim=12, text_dim=6, d_model=32, self_num_layers=1,
                      num_heads=2)
    ds = SyntheticDataset([30, 60, 100, 20, 64, 128, 90, 40, 50], cfg, seed=1)
    loader = BatchLoader(ds, batch_size=2, buckets=(64, 128), seed=0, pack=pack)
    n = loader.batches_per_epoch(0)
    profiling.clear()
    with _cpu_profile():
        taken = list(loader.epoch(0))
    recs = profiling.records()
    assert len(taken) == n
    loads = _named(recs, "loader.load")
    assert len(loads) == n and len(_named(recs, "loader.wait")) == n + 1
    assert sum(r.ids["videos"] for r in loads) == len(ds)
    assert {r.thread for r in loads} != {r.thread for r in _named(recs, "loader.wait")}

    profiling.clear()
    with _cpu_profile():
        batches = loader.epoch(1)
        part = list(itertools.islice(batches, 2))
        batches.close()
    assert len(part) == 2
    assert len(_named(profiling.records(), "loader.wait")) == 2
