"""The port's serving daemon (``python -m repurpose_tpu_torch.serve``) on the
CPU, against in-process ``score_videos`` and against root ``serve.py``.

One ``.pth`` of JAX-initialised weights (written through the port's
``models/convert.py``) serves both daemons, with the tiny config of
``tests/test_serve.py``. The port's daemon runs as a subprocess on
``--device cpu``, unpacked and ``--pack``, beside root ``serve.py
--torch_ckpt`` unpacked and packed. Held:

- each answer equals in-process port ``score_videos`` on the same videos bit
  for bit (JSON carries float32 values exactly as float64);
- each answer matches root ``serve.py``'s within ``tests/test_serve.py``'s
  tolerances: rtol/atol 1e-5 on segments, 1e-5 / 1e-6 on scores (float32 in
  both frameworks, sums in another order); packed 1e-4 / 1e-4 and 1e-4 / 1e-5;
- concurrent clients are answered, each in its own order, and
  ``scored_total`` adds up; 400, 404, 413 and ``/healthz`` with its
  ``drains_total``; SIGTERM and SIGINT exit 0; ``main`` raises without CUDA
  unless ``--device cpu``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repurpose_tpu.config import load_config as jax_load_config
from repurpose_tpu.models import MMCT as JaxMMCT
from repurpose_tpu_torch import serve
from repurpose_tpu_torch.config import load_config
from repurpose_tpu_torch.infer import InferencePipeline
from repurpose_tpu_torch.models import state_dict_from_jax_params

ROOT = Path(__file__).resolve().parent.parent

TINY_YAML = """
train_dataset: {label_path: d.json, video_path: v, audio_path: a, text_path: t}
val_dataset: {label_path: d.json, video_path: v, audio_path: a, text_path: t}
test_dataset: {label_path: d.json, video_path: v, audio_path: a, text_path: t}
model:
  vis_dim: 8
  aud_dim: 12
  text_dim: 6
  d_model: 32
  self_num_layers: 1
  num_heads: 2
train:
  seed: 11
  lr: 0.001
  epochs: 1
  weight_decay: 0.0
  warmup_epochs: 0
  save_epochs: 1
  batch_size: 2
  eval_freq: 0
  intra_epoch_eval_freq: 0
test_cfg:
  pre_nms_topk: 16
  pre_nms_thresh: 0.2
  duration_thresh: 1
  duration_thresh_max: 90
  max_seg_per_min: 2.0
  nms_sigma: 0.5
  min_score: 0.01
tpu:
  mesh: {data: 1, model: 1, seq: 1}
  buckets: [64, 128]
  compute_dtype: float32
  attention_impl: xla
  matmul_precision: highest
"""
TOL = {False: dict(seg=(1e-5, 1e-5), score=(1e-5, 1e-6)),
       True: dict(seg=(1e-4, 1e-4), score=(1e-4, 1e-5))}
LENGTHS = [30, 100, 64, 50, 17, 128]


def _videos(seed, lens, prefix="vid"):
    rng = np.random.default_rng(seed)
    return [{"video_id": f"{prefix}{i}",
             "visual": rng.normal(size=(t, 8)).astype(np.float32),
             "audio": rng.normal(size=(t, 12)).astype(np.float32),
             "text": rng.normal(size=(t, 6)).astype(np.float32)} for i, t in enumerate(lens)]


def _payload(videos):
    return {"videos": [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
                        for k, v in d.items()} for d in videos]}


def _post(url, payload, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _start(cmd, env=None):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT, env=env)


def _ready(proc) -> tuple[str, str]:
    """(base URL, readiness line) of a started daemon."""
    line = proc.stdout.readline()
    assert "serving on" in line, (line, proc.stderr.read()[-3000:])
    port = int(line.split("http://")[1].split(" ")[0].rsplit(":", 1)[1])
    return f"http://127.0.0.1:{port}", line


def _stop(proc, sig=signal.SIGTERM) -> int:
    if proc.poll() is None:
        proc.send_signal(sig)
    try:
        return proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        raise


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The config, the .pth, and four daemons: the port's and root
    ``serve.py``'s, each unpacked and packed."""
    tmp = tmp_path_factory.mktemp("serve")
    cfg_path = tmp / "tiny.yaml"
    cfg_path.write_text(TINY_YAML)
    jcfg = jax_load_config(str(cfg_path))
    params = jax.device_get(JaxMMCT(jcfg.model).init_params(jax.random.key(4)))
    # offsets of a few seconds, so that decode keeps clips past duration_thresh
    params["reg_head"]["out"]["bias"] = np.full((2,), 4.0, np.float32)
    ckpt = tmp / "tiny.pth"
    torch.save({"model": state_dict_from_jax_params(params), "epoch": 0, "loss": 0.0}, ckpt)
    common = ["--config_path", str(cfg_path), "--torch_ckpt", str(ckpt), "--port", "0",
              "--batch_size", "2", "--max_wait_ms", "50"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {}
    for pack in (False, True):
        extra = ["--pack"] if pack else []
        procs["port", pack] = _start([sys.executable, "-m", "repurpose_tpu_torch.serve",
                                      *common, *extra, "--device", "cpu"])
        procs["root", pack] = _start([sys.executable, str(ROOT / "serve.py"), *common,
                                      *extra], env=env)
    try:
        urls = {k: _ready(p)[0] for k, p in procs.items()}
        yield cfg_path, ckpt, urls
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def _in_process(cfg_path, ckpt, videos, pack):
    cfg = load_config(str(cfg_path))
    from repurpose_tpu_torch.models import load_reference_checkpoint

    pipe = InferencePipeline(cfg.model, load_reference_checkpoint(str(ckpt)), cfg.test_cfg,
                             device="cpu")
    return [serve._json_result(r) for r in pipe.score_videos(
        videos, buckets=cfg.train.buckets, batch_size=2, pack=pack)]


@pytest.mark.parametrize("pack", [False, True])
def test_answers_equal_score_videos_and_match_root_serve(setup, pack):
    cfg_path, ckpt, urls = setup
    videos = _videos(5, LENGTHS)
    status, got = _post(urls["port", pack] + "/score", _payload(videos))
    assert status == 200
    got = got["results"]
    assert [r["video_id"] for r in got] == [v["video_id"] for v in videos]
    assert got == _in_process(cfg_path, ckpt, videos, pack)  # bit for bit
    assert sum(len(r["scores"]) for r in got) > 0  # the comparison holds clips
    status, want = _post(urls["root", pack] + "/score", _payload(videos))
    assert status == 200
    tol = TOL[pack]
    for a, b in zip(got, want["results"]):
        assert (a["video_id"], a["duration"]) == (b["video_id"], b["duration"])
        np.testing.assert_allclose(np.asarray(a["segments"], np.float32).reshape(-1, 2),
                                   np.asarray(b["segments"], np.float32).reshape(-1, 2),
                                   rtol=tol["seg"][0], atol=tol["seg"][1])
        np.testing.assert_allclose(np.asarray(a["scores"], np.float32),
                                   np.asarray(b["scores"], np.float32),
                                   rtol=tol["score"][0], atol=tol["score"][1])


@pytest.mark.parametrize("pack", [False, True])
def test_concurrent_clients_are_answered_in_order_and_counted(setup, pack):
    cfg_path, ckpt, urls = setup
    base = urls["port", pack]
    before = _get(base + "/healthz")[1]["scored_total"]
    clients = {f"c{c}": _videos(20 + c, [17 + 13 * c, 90 - 7 * c, 40], prefix=f"c{c}v")
               for c in range(4)}
    out = {}

    def client(name):
        out[name] = _post(base + "/score", _payload(clients[name]))

    threads = [threading.Thread(target=client, args=(n,)) for n in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert set(out) == set(clients), f"client(s) unanswered: {set(clients) - set(out)}"
    for name, videos in clients.items():
        status, body = out[name]
        assert status == 200
        assert [r["video_id"] for r in body["results"]] == [v["video_id"] for v in videos]
        assert [r["duration"] for r in body["results"]] == [len(v["visual"]) for v in videos]
    health = _get(base + "/healthz")[1]
    assert health["scored_total"] - before == sum(len(v) for v in clients.values())


def test_bad_requests_and_healthz(setup):
    cfg_path, ckpt, urls = setup
    base = urls["port", False]
    status, health = _get(base + "/healthz")
    assert status == 200 and health["status"] == "ok"
    assert health["platform"] == "cpu" and health["card"] == "cpu"
    assert health["buckets"] == [64, 128] and health["pack"] is False
    assert health["batch_size"] == 2
    # one request is one drain: videos per drain is scored_total / drains_total
    assert 0 <= health["drains_total"] <= health["scored_total"]
    videos = _videos(9, [40, 70])
    assert _post(base + "/score", _payload(videos))[0] == 200
    after = _get(base + "/healthz")[1]
    assert after["drains_total"] - health["drains_total"] == 1
    assert after["scored_total"] - health["scored_total"] == len(videos)
    bad = [({"videos": [{"video_id": "nofeat"}]}, "features"),
           ({"videos": []}, "non-empty"),
           ({"videos": [{"visual": [[0.0] * 7], "audio": [[0.0] * 12],
                         "text": [[0.0] * 6]}]}, "expected")]
    for payload, word in bad:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/score", payload)
        assert e.value.code == 400 and word in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/nowhere")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/nowhere", {"videos": []})
    assert e.value.code == 404
    req = urllib.request.Request(base + "/score", data=b"", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 413
    assert _get(base + "/healthz")[0] == 200  # still serving


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT])
def test_signals_stop_the_daemon_with_exit_code_0(setup, sig):
    cfg_path, ckpt, _ = setup
    proc = _start([sys.executable, "-m", "repurpose_tpu_torch.serve", "--config_path",
                   str(cfg_path), "--torch_ckpt", str(ckpt), "--port", "0", "--device",
                   "cpu", "--warmup"])
    try:
        base, line = _ready(proc)
        assert "platform=cpu" in line and "buckets=[64, 128]" in line
        assert _get(base + "/healthz")[0] == 200
    finally:
        assert _stop(proc, sig) == 0


def test_main_needs_cuda_unless_asked_for_the_cpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    cfg_path, ckpt, _ = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--config_path", str(cfg_path), "--torch_ckpt", str(ckpt)])
    args = serve.parse_args(["--config_path", str(cfg_path), "--torch_ckpt", str(ckpt),
                             "--port", "0", "--device", "cpu"])
    server, scorer, platform, card = serve.make_server(load_config(str(cfg_path)), args)
    try:
        assert (platform, card) == ("cpu", "cpu") and scorer.is_alive()
    finally:
        scorer.stop()
        scorer.join(timeout=30)
        server.server_close()
    assert not scorer.is_alive()


def test_json_config_needs_no_yaml(setup, tmp_path):
    """``--config_path x.json`` (the schema as JSON) loads the same config as
    the YAML file: the card's machine has no PyYAML."""
    cfg_path, _, _ = setup
    import yaml

    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(yaml.safe_load(TINY_YAML)))
    assert load_config(str(path)).to_dict() == load_config(str(cfg_path)).to_dict()
