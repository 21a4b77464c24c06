"""The trainer and data leftovers of the port, on the CPU, against the JAX
package where it has a counterpart.

- ``param_histograms`` and the step's gradient histograms against the JAX
  ones on converted weights and one batch: parameter counts exactly, edges
  within 1e-6 of the range (XLA fuses ``jnp.linspace``'s a * (1 - s) + b * s
  into one rounding); gradient histograms, whose values agree only to
  float32 op order (rtol 1e-4), within 2 + 0.2 % of the entries per layer
  moved across a bin edge, edges within 1e-4 of the range;
- ``RepurposeDataset.load_batch`` (the native loader, and the numpy route
  with the library unavailable) against the JAX ``load_batch`` bit for bit,
  the loader's batches through it, and ``use_cache``;
- the train CLI's ``--profile`` (a trace and an operator table),
  ``--async-ckpt`` (a run and its resume equal the synchronous ones bit for
  bit), ``--debug-viz`` (figures and the health log; skipped where
  matplotlib is not installed) and ``--wandb`` against a fake ``wandb``
  module.
"""

import dataclasses
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repurpose_tpu.config import ModelConfig as JModelConfig
from repurpose_tpu.config import TrainConfig as JTrainConfig
from repurpose_tpu.data.dataset import RepurposeDataset as JaxDataset
from repurpose_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from repurpose_tpu.train.state import create_train_state
from repurpose_tpu.train.step import make_train_step as jax_make_train_step
from repurpose_tpu.train.step import param_histograms as jax_param_histograms
from repurpose_tpu_torch import native
from repurpose_tpu_torch.config import ModelConfig, TrainConfig, load_config
from repurpose_tpu_torch.data.batching import collate
from repurpose_tpu_torch.data.dataset import RepurposeDataset
from repurpose_tpu_torch.data.loader import BatchLoader
from repurpose_tpu_torch.data.synthetic import SyntheticDataset, write_synthetic_dataset
from repurpose_tpu_torch.models import build_model, state_dict_from_jax_params
from repurpose_tpu_torch.train import __main__ as cli
from repurpose_tpu_torch.train.checkpoint import Checkpointer
from repurpose_tpu_torch.train.state import TrainState, make_optimizer
from repurpose_tpu_torch.train.step import (
    HIST_BINS,
    batch_to_device,
    kernel_layer_names,
    make_train_step,
    param_histograms,
)

MODEL = dict(vis_dim=8, aud_dim=12, text_dim=6, d_model=16, self_num_layers=1, num_heads=2,
             d_ff=32, hidden_dim=8, dropout=0.0, compute_dtype="float32",
             attn_softmax_dtype="float32")
JCFG, PCFG = JModelConfig(**MODEL, matmul_precision="highest"), ModelConfig(**MODEL)

TINY_YAML = """
model: {vis_dim: 8, aud_dim: 12, text_dim: 6, d_model: 16, self_num_layers: 1,
        num_heads: 2, d_ff: 32}
train: {seed: 7, lr: 0.001, epochs: 2, save_epochs: 1, batch_size: 2, eval_freq: 1,
        intra_epoch_eval_freq: 0}
test_cfg: {pre_nms_topk: 16, pre_nms_thresh: 0.3, duration_thresh: 1,
           duration_thresh_max: 90, max_seg_per_min: 2.0, nms_sigma: 0.5, min_score: 0.01}
tpu:
  mesh: {data: 1, model: 1, seq: 1}
  buckets: [128, 256]
  compute_dtype: float32
  pack_sequences: true
  loss_norm: batch_size
"""


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_to_port_kernel_order(params) -> list[int]:
    """For each port matrix parameter (kernel_layer_names order), its row in
    the JAX per-kernel telemetry."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32) for i, (_, x) in enumerate(flat)])
    sd = state_dict_from_jax_params(tagged)
    kernels = [i for i, (path, _) in enumerate(flat)
               if "/".join(getattr(p, "key", str(p)) for p in path).endswith("kernel")]
    return [kernels.index(int(sd[n].flatten()[0]))
            for n in kernel_layer_names(build_model(PCFG, "cpu"))]


def _edges_close(got, want, rel):
    span = np.abs(want[:, -1] - want[:, 0])[:, None]
    assert np.all(np.abs(got - want) <= rel * np.maximum(span, 1e-12))


def test_histograms_match_the_jax_step():
    tc = TrainConfig(batch_size=2, buckets=(64,), epochs=1, lr=1e-3, loss_norm="batch_size")
    jtc = JTrainConfig(**dataclasses.asdict(tc) | {"buckets": tc.buckets})
    jstate, tx, jsched = create_train_state(JCFG, jtc, steps_per_epoch=1,
                                            rng=jax.random.key(2))
    order = _jax_to_port_kernel_order(jstate.params)
    model = build_model(PCFG, "cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.device_get(jstate.params)),
                          strict=True)

    want = jax_param_histograms(jstate.params)
    got = param_histograms(model)
    assert got["counts"].shape == (len(order), HIST_BINS)
    np.testing.assert_array_equal(got["counts"].numpy(), np.asarray(want["counts"])[order])
    _edges_close(got["edges"].numpy(), np.asarray(want["edges"])[order], 1e-6)

    durs = [40, 55]
    jb = collate_jax(JSyntheticDataset(durs, JCFG, seed=4))
    pb = collate([SyntheticDataset(durs, PCFG, seed=4)[i] for i in range(2)], (64,), 2)
    jstep = jax_make_train_step(JCFG, jtc, tx, jsched, donate=False,
                                per_layer_grad_norms=True, grad_histograms=True)
    _, jm = jstep(jstate, jb, jax.random.key(7))
    opt, sched = make_optimizer(model, tc, steps_per_epoch=1)
    m = make_train_step(PCFG, tc, sched)(TrainState(model=model, optimizer=opt),
                                         batch_to_device(pb, "cpu"), grad_histograms=True)
    counts, wcounts = m["hist/grads/counts"].numpy(), np.asarray(jm["hist/grads/counts"])[order]
    sizes = [p.numel() for p in model.parameters() if p.ndim == 2]
    for row, n in enumerate(sizes):
        assert counts[row].sum() == wcounts[row].sum() == n
        assert np.abs(counts[row] - wcounts[row]).sum() <= 2 * (2 + 0.002 * n), row
    _edges_close(m["hist/grads/edges"].numpy(), np.asarray(jm["hist/grads/edges"])[order], 1e-4)


def collate_jax(ds):
    from repurpose_tpu.data.batching import collate as jax_collate

    return jax_collate([ds[i] for i in range(len(ds))], (64,), 2)


# -- the whole-batch loader -----------------------------------------------------------


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("split")
    return write_synthetic_dataset(str(root), [61, 130, 97, 240, 80], PCFG, seed=5)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_load_batch_equals_the_jax_load_batch(split, monkeypatch, route):
    assert native.available()  # the loader builds wherever a C++ compiler is installed
    jds = JaxDataset(split, validate=False, use_cache=False)
    ds = RepurposeDataset(split, validate=False, use_cache=False)
    for idx, bs in (([0, 2, 4], 4), ([1, 3], 2)):
        want = jds.load_batch(idx, (128, 256), bs)
        assert want is not None
        if route == "numpy":
            monkeypatch.setattr(native, "available", lambda: False)
            assert ds.load_batch(idx, (128, 256), bs) is None
            got = collate([ds[i] for i in idx], (128, 256), bs)
        else:
            got = ds.load_batch(idx, (128, 256), bs)
        for name, a, b in zip(want._fields, got, want):
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_loader_batches_go_through_load_batch(split, monkeypatch):
    ds = RepurposeDataset(split, validate=False, use_cache=False)
    calls = []
    load = ds.load_batch
    monkeypatch.setattr(ds, "load_batch", lambda *a: calls.append(a) or load(*a))
    loader = BatchLoader(ds, batch_size=2, buckets=(128, 256), shuffle=True, seed=3)
    got = list(loader.epoch(0))
    assert len(calls) == len(got) > 0
    monkeypatch.setattr(native, "available", lambda: False)
    for a, b in zip(got, loader.epoch(0)):
        for x, y in zip(a, b):
            assert (x is None and y is None) or np.array_equal(x, y)


def test_use_cache(split):
    label_dir = os.path.dirname(split.label_path)
    caches = lambda: [f for f in os.listdir(label_dir) if "_filter_cache_" in f]  # noqa: E731
    for f in caches():
        os.remove(os.path.join(label_dir, f))
    fresh = RepurposeDataset(split, validate=True, use_cache=False)
    assert caches() == []
    cached = RepurposeDataset(split, validate=True)
    assert len(caches()) == 1
    again = RepurposeDataset(split, validate=True)
    assert [e["youtube_id"] for e in fresh.entries] == [e["youtube_id"] for e in again.entries]
    assert len(cached) == len(fresh) == 5


# -- the train CLI's flags ---------------------------------------------------------------


@pytest.fixture
def cfg_path(tmp_path):
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    return str(path)


def _argv(cfg_path, workdir, *extra, epochs=1):
    return ["--config_path", cfg_path, "--synthetic", "8", "--epochs", str(epochs),
            "--workdir", str(workdir), "--device", "cpu", *extra]


def test_profile_writes_a_trace_of_the_first_epoch(cfg_path, tmp_path):
    workdir = tmp_path / "run"
    assert cli.main(_argv(cfg_path, workdir, "--profile", epochs=2)) == 0
    trace = json.load(open(workdir / "profile" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "train_step" in names  # the annotated span of every step
    assert "Self CPU" in (workdir / "profile" / "ops.txt").read_text()
    steps = Checkpointer(str(workdir / "ckpt")).all_steps()
    assert len(steps) == 2  # the second epoch ran after the profiled one


def _final_state(workdir):
    ck = Checkpointer(str(workdir / "ckpt"))
    step = ck.latest_step()
    return step, torch.load(ck._path(step), map_location="cpu", weights_only=True)


def test_async_checkpoints_resume_like_synchronous_ones(cfg_path, tmp_path):
    runs = {}
    for mode, extra in (("sync", []), ("async", ["--async-ckpt"])):
        workdir = tmp_path / mode
        assert cli.main(_argv(cfg_path, workdir, *extra)) == 0  # epoch 1, checkpointed
        assert cli.main(_argv(cfg_path, workdir, "--resume", *extra, epochs=2)) == 0
        runs[mode] = _final_state(workdir)
    (s1, a), (s2, b) = runs["sync"], runs["async"]
    assert s1 == s2 > 0
    for part in ("model", "optimizer"):
        flat_a = torch.utils._pytree.tree_flatten(a[part])[0]
        flat_b = torch.utils._pytree.tree_flatten(b[part])[0]
        assert len(flat_a) == len(flat_b)
        for x, y in zip(flat_a, flat_b):
            assert torch.equal(x, y) if torch.is_tensor(x) else x == y
    assert a["meta"] == b["meta"] and a["step"] == b["step"]


def test_async_checkpointer_waits_and_reports_a_failed_write(tmp_path, monkeypatch):
    model = build_model(PCFG, "cpu")
    opt, _ = make_optimizer(model, TrainConfig(batch_size=2, buckets=(64,)), 1)
    state = TrainState(model=model, optimizer=opt)
    ck = Checkpointer(str(tmp_path / "ck"), async_save=True)
    ck.save(3, state, {"epoch": 1})
    assert ck.latest_step() == 3  # waits for the write
    monkeypatch.setattr(torch, "save", lambda *a, **k: (_ for _ in ()).throw(OSError("disk")))
    ck.save(4, state)
    with pytest.raises(RuntimeError, match="asynchronous checkpoint write failed"):
        ck.close()


def test_debug_viz_writes_figures_and_the_health_log(cfg_path, tmp_path):
    pytest.importorskip("matplotlib", reason="--debug-viz renders with matplotlib")
    workdir = tmp_path / "run"
    assert cli.main(_argv(cfg_path, workdir, "--debug-viz")) == 0
    (tag,) = os.listdir(workdir / "debug")
    figures = os.listdir(workdir / "debug" / tag / "visualizations")
    summary = json.load(open(workdir / "debug" / tag / "logs" / "summary.json"))
    assert summary["n_samples"] == len(figures) == 1  # the one synthetic test video
    assert all(f.endswith(".png") for f in figures)
    assert set(summary) >= {"loss", "prob_stats", "offset_std", "collapse_warnings"}


class _FakeWandb(types.ModuleType):
    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw))

    def log(self, data, step=None):
        self.calls.append(("log", data, step))

    def finish(self):
        self.calls.append(("finish",))

    def Histogram(self, np_histogram):  # noqa: N802 - wandb's name
        return ("hist", np_histogram)

    def Image(self, path):  # noqa: N802 - wandb's name
        return ("image", path)


def test_wandb_logs_metrics_and_histograms(cfg_path, tmp_path, monkeypatch):
    fake = _FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    assert cli.main(_argv(cfg_path, tmp_path / "run", "--wandb")) == 0
    kinds = [c[0] for c in fake.calls]
    assert kinds[0] == "init" and kinds[-1] == "finish"
    assert fake.calls[0][1]["config"]["train"]["seed"] == 7
    logged = [c[1] for c in fake.calls if c[0] == "log"]
    assert any("batch/loss" in d for d in logged) and any("tiou/mean" in d for d in logged)
    hists = [d for d in logged if any(k.startswith("hist/grads/") for k in d)]
    assert len(hists) == 1 and all(v[0] == "hist" for v in hists[0].values())
    names = kernel_layer_names(build_model(load_config(cfg_path).model, "cpu"))
    assert set(hists[0]) == {f"hist/grads/{n}" for n in names}


def test_wandb_missing_degrades_to_jsonl(cfg_path, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    workdir = tmp_path / "run"
    assert cli.main(_argv(cfg_path, workdir, "--wandb")) == 0
    lines = [json.loads(x) for x in open(workdir / "metrics.jsonl")]
    assert any("batch/loss" in m for m in lines)
    assert any(k.startswith("hist/params/") for m in lines for k in m)


def test_eval_forward_gives_eval_mode_outputs(cfg_path, tmp_path):
    """``Trainer.eval_forward``: the raw outputs of a host batch in eval mode
    (dropout off: two calls agree), the model's training mode restored."""
    from repurpose_tpu_torch.train.loop import Trainer

    cfg = load_config(cfg_path)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.5))
    train_ds = cli.build_datasets(cfg, 4)[0]
    trainer = Trainer(cfg, str(tmp_path / "w"), train_ds, device="cpu")
    batch = collate([train_ds[i] for i in range(2)], cfg.train.buckets, 2)
    trainer.state.model.train()
    a, b = trainer.eval_forward(batch), trainer.eval_forward(batch)
    assert trainer.state.model.training
    assert a.cls_logits.shape == (2, batch.mask.shape[1], 1)
    assert torch.equal(a.cls_logits, b.cls_logits) and torch.equal(a.offsets, b.offsets)
    trainer.close()
