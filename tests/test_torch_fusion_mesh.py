"""The fusion variants (``fusion: cross`` / ``bottleneck``) on a mesh, on the
CPU, against the JAX package and the port's one-process runs.

Two worlds of gloo workers (``tests/gloo_world.py``): one of 2 ranks,
re-grouped into ``seq`` = 2 with ``attention_impl="ring"`` and into
``model`` = 2, and one of 4 ranks, ``data`` = 2 × ``model`` = 2. The
models are ``tests/test_torch_fusion.py``'s ``TINY`` widths in float32, on
the JAX params of ``_jax_params`` carried across by ``models/convert.py``;
the global batch is four unpacked synthetic videos of 30 / 50 / 64 / 40 s at
bucket 64. This process computes the JAX references meanwhile: the JAX
``_loss_fn`` on ``make_global_batch(..., seq_sharded=True)`` over a
2-device ``seq`` mesh, and the JAX step with ``param_shardings`` on the
``model`` = 2 and ``data`` = 2 × ``model`` = 2 meshes of the 8-device
virtual CPU mesh.

Tolerances: losses and gradient norms rtol 1e-5 (float32, the same sums
in another order), against one process and against JAX; parameters after
the steps against one process within 1e-5 of each tensor's largest
element, but for the key biases, whose gradient is float32 noise (softmax
cancels a key bias), which Adam may move by lr a step either way; the
served clips as ``tests/test_torch_ring_attention.py`` holds them (scores
atol 1e-5, segments atol 1e-4, labels exact).
"""

import concurrent.futures
import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repurpose_tpu.config import MeshConfig as JMeshConfig
from repurpose_tpu.config import ModelConfig as JModelConfig
from repurpose_tpu.config import TrainConfig as JTrainConfig
from repurpose_tpu.data.batching import collate as jax_collate
from repurpose_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from repurpose_tpu.models import build_model as jax_build_model
from repurpose_tpu.parallel.mesh import create_mesh as jax_create_mesh
from repurpose_tpu.parallel.sharding import make_global_batch, shard_params
from repurpose_tpu.train.state import TrainState as JTrainState
from repurpose_tpu.train.state import make_optimizer as jax_make_optimizer
from repurpose_tpu.train.step import _loss_fn as jax_loss_fn
from repurpose_tpu.train.step import make_train_step as jax_make_train_step
from repurpose_tpu_torch.config import Config, ModelConfig, TestConfig, TrainConfig
from repurpose_tpu_torch.data.batching import Batch
from repurpose_tpu_torch.data.synthetic import SyntheticDataset
from repurpose_tpu_torch.infer import InferencePipeline
from repurpose_tpu_torch.models import build_model, state_dict_from_jax_params
from repurpose_tpu_torch.models.bottleneck import MMCTBottleneck
from repurpose_tpu_torch.models.cross_modal import MMCTCross
from repurpose_tpu_torch.parallel import sharding
from repurpose_tpu_torch.parallel.mesh import Mesh
from repurpose_tpu_torch.parallel.pipeline import validate_pipeline
from repurpose_tpu_torch.parallel.sharding import param_sharding_rule, seq_split
from repurpose_tpu_torch.train.checkpoint import Checkpointer
from repurpose_tpu_torch.train.loop import Trainer
from repurpose_tpu_torch.train.state import TrainState, make_optimizer
from repurpose_tpu_torch.train.step import batch_to_device, make_eval_step, make_train_step
from test_torch_fusion import TINY, _jax_params
import gloo_world

FUSIONS = ("cross", "bottleneck")
DURS = [30, 50, 64, 40]
STEPS = 2
# mesh name -> (world, axes, model overrides)
MESHES = {"seq2": (2, dict(data=1, seq=2), dict(attention_impl="ring")),
          "model2": (2, dict(data=1, model=2), {}),
          "data2_model2": (4, dict(data=2, model=2), {})}
TP_MESHES = ("model2", "data2_model2")
TEST_CFG = dict(pre_nms_topk=64, pre_nms_thresh=0.0, duration_thresh=0.001,
                duration_thresh_max=90.0, max_seg_per_min=2.0, min_score=0.0)
DROPOUT = 0.1


def _train_kw(data: int = 1) -> dict:
    """TrainConfig kwargs: ``batch_size`` per data rank of the global 4."""
    return dict(batch_size=len(DURS) // data, buckets=(64,), epochs=1, lr=1e-3,
                loss_norm="batch_size", eval_freq=100, intra_epoch_eval_freq=0,
                save_epochs=100)


def _model(fusion: str, **kw) -> ModelConfig:
    return ModelConfig(**{**TINY, **kw}, fusion=fusion)


WORKER = r'''
import json
import numpy as np
from repurpose_tpu_torch.config import Config, MeshConfig, ModelConfig, TestConfig, TrainConfig
from repurpose_tpu_torch.data.batching import Batch
from repurpose_tpu_torch.data.synthetic import SyntheticDataset
from repurpose_tpu_torch.infer import InferencePipeline
from repurpose_tpu_torch.models import build_model
from repurpose_tpu_torch.parallel.mesh import create_mesh
from repurpose_tpu_torch.parallel.sharding import local_rows, seq_split
from repurpose_tpu_torch.train.checkpoint import Checkpointer
from repurpose_tpu_torch.train.loop import Trainer
from repurpose_tpu_torch.train.state import TrainState, make_optimizer
from repurpose_tpu_torch.train.step import batch_to_device, make_eval_step, make_train_step

spec = json.load(open(f"{root}/spec.json"))
z = np.load(f"{root}/batch.npz")
BATCH = Batch(*[z[f] if f in z.files else None for f in Batch._fields])

out = {}
for case in spec["cases"][str(world)]:
    name, fusion, kind = case["name"], case["fusion"], case["kind"]
    mesh = create_mesh(MeshConfig(**case["mesh"]), "gloo", "cpu")
    mc = ModelConfig(**case["model"])
    tc = TrainConfig(**case["train"])
    sd = torch.load(f"{root}/init_{fusion}.pt", weights_only=True)
    if kind == "step":
        model = build_model(mc, "cpu", mesh=mesh)
        model.load_state_dict(sd, strict=True)
        model.set_dropout_generator(torch.Generator().manual_seed(tc.seed))
        opt, schedule = make_optimizer(model, tc, 2, mesh)
        state = TrainState(model, opt, mesh=mesh)
        step = make_train_step(mc, tc, schedule, mesh)
        # the port's own staging: this rank's rows, and its columns only
        # where the model rings
        b = batch_to_device(local_rows(BATCH, mesh, seq=seq_split(mc, mesh)), "cpu")
        probe = {k: float(v) for k, v in make_eval_step(tc, mesh)(model, b).items()}
        hist = []
        for _ in range(case["steps"]):
            m = step(state, b)
            hist.append([float(m["loss"]), float(m["grad_norm"])])
        out[name] = {"hist": hist, "probe": probe, "local": list(b.visual.shape[:2]),
                     "params": {k: v.clone() for k, v in model.state_dict().items()}}
        if case.get("ckpt"):  # rank 0 writes the gathered state
            Checkpointer(f"{root}/ck_{fusion}").save(state.step, state, {"epoch": 0})
    elif kind == "score":
        pipe = InferencePipeline(mc, sd, TestConfig(**spec["test"]), device="cpu", mesh=mesh)
        rows = local_rows(BATCH, mesh)
        out[name] = {"ring": pipe.ring, "scored": pipe.score_batch(
            rows.visual, rows.audio, rows.text, rows.mask, rows.durations)}
    elif kind == "trainer":
        cfg = Config(model=mc, train=tc, mesh=MeshConfig(**case["mesh"]),
                     test_cfg=TestConfig(**spec["test"]))
        ds = SyntheticDataset(spec["durs"], mc, seed=1)
        trainer = Trainer(cfg, f"{root}/{name}", ds, val_ds=ds, test_ds=ds, init_params=sd,
                          device="cpu")
        out[name] = {"local": list(trainer._device_batch(BATCH).visual.shape[:2]),
                     "val": trainer._val_probe(), "eval": trainer.evaluate(),
                     "ring_eval": trainer.pipeline.ring}
        trainer.close()
    dist.barrier()
torch.save(out, f"{root}/out{world}_rank{rank}.pt")
dist.destroy_process_group()
'''


def _cases() -> dict:
    cases = {"2": [], "4": []}
    for fusion in FUSIONS:
        for mesh_name, (world, axes, model_kw) in MESHES.items():
            mc = dataclasses.asdict(_model(fusion, **model_kw))
            base = dict(fusion=fusion, mesh=axes, model=mc,
                        train=_train_kw(axes.get("data", 1)))
            cases[str(world)].append(dict(base, kind="step", name=f"{mesh_name}_{fusion}",
                                          steps=STEPS, ckpt=mesh_name == "data2_model2"))
        seq_base = dict(fusion=fusion, mesh=MESHES["seq2"][1], train=_train_kw(),
                        model=dataclasses.asdict(_model(fusion, attention_impl="ring")))
        cases["2"].append(dict(seq_base, kind="trainer", name=f"trainer_seq2_{fusion}"))
        tp_base = dict(fusion=fusion, mesh=MESHES["model2"][1], train=_train_kw())
        cases["2"].append(dict(tp_base, kind="step", name=f"dropout_model2_{fusion}",
                               steps=STEPS,
                               model=dataclasses.asdict(_model(fusion, dropout=DROPOUT))))
        cases["2"].append(dict(tp_base, kind="score", name=f"score_model2_{fusion}",
                               model=dataclasses.asdict(_model(fusion))))
    return cases


def _jax_cfg(fusion: str) -> JModelConfig:
    return JModelConfig(**TINY, fusion=fusion, matmul_precision="highest")


def _jax_seq2_loss(fusion: str, params, batch) -> float:
    """The JAX ``_loss_fn`` on the batch sharded over a 2-device ``seq`` mesh
    (``make_global_batch(..., seq_sharded=True)``), the JAX Trainer's staging."""
    mesh = jax_create_mesh(JMeshConfig(data=1, seq=2))
    model = jax_build_model(_jax_cfg(fusion), mesh=mesh)
    jtc = JTrainConfig(**_train_kw())
    total, _ = jax.jit(lambda p, b: jax_loss_fn(model, jtc, p, b, None, False))(
        params, make_global_batch(batch, mesh, seq_sharded=True))
    return float(total)


def _jax_mesh_step(fusion: str, params, batch, axes: dict) -> np.ndarray:
    """(loss, grad norm) of the JAX step with the params placed by
    ``param_shardings`` and the batch over ``data``, on the mesh ``axes``
    (one step: a second would compile again, for the shardings the first
    one's outputs take)."""
    jcfg, jtc = _jax_cfg(fusion), JTrainConfig(**_train_kw())
    tx, sched = jax_make_optimizer(jtc, 2)
    mesh = jax_create_mesh(JMeshConfig(**axes))
    placed = shard_params(params, mesh)
    state = JTrainState(params=placed, opt_state=tx.init(placed), step=jnp.int32(0))
    step = jax_make_train_step(jcfg, jtc, tx, sched, donate=False)
    _, m = step(state, make_global_batch(batch, mesh), jax.random.key(7))
    return np.asarray([float(m["loss"]), float(m["grad_norm"])])


def _one_process(fusion: str, sd: dict, batch: Batch, steps: int = STEPS, state=None,
                 **model_kw) -> dict:
    """The port's one-process run on the global batch: (loss, grad norm) a
    step, the val probe before the steps, the parameters after them."""
    mc = _model(fusion, **model_kw)
    tc = TrainConfig(**_train_kw())
    if state is None:
        model = build_model(mc, "cpu")
        model.load_state_dict(sd, strict=True)
        model.set_dropout_generator(torch.Generator().manual_seed(tc.seed))
        state = TrainState(model, make_optimizer(model, tc, 2)[0])
    _, schedule = make_optimizer(state.model, tc, 2)
    step = make_train_step(mc, tc, schedule)
    dev = batch_to_device(batch, "cpu")
    probe = {k: float(v) for k, v in make_eval_step(tc)(state.model, dev).items()}
    hist = []
    for _ in range(steps):
        m = step(state, dev)
        hist.append([float(m["loss"]), float(m["grad_norm"])])
    return dict(hist=np.asarray(hist), probe=probe, state=state,
                params={k: v.clone() for k, v in state.model.state_dict().items()})


def _one_process_trainer(root, fusion: str, sd: dict) -> dict:
    cfg = Config(model=_model(fusion), train=TrainConfig(**_train_kw()),
                 test_cfg=TestConfig(**TEST_CFG))
    ds = SyntheticDataset(DURS, cfg.model, seed=1)
    trainer = Trainer(cfg, str(root / f"one_{fusion}"), ds, val_ds=ds, test_ds=ds,
                      init_params=sd, device="cpu")
    out = {"val": trainer._val_probe(), "eval": trainer.evaluate()}
    trainer.close()
    return out


def _reg_offset(params: dict) -> dict:
    """``params`` (not changed) with the regression head's last bias at 15:
    offsets of about 15 s give clips that the decode keeps and tIoU scores."""
    head = dict(params["reg_head"])
    head["out"] = dict(head["out"], bias=np.full_like(np.asarray(head["out"]["bias"]), 15.0))
    return dict(params, reg_head=head)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' results, and the references they are held to."""
    root = tmp_path_factory.mktemp("fusion_mesh")
    jds = JSyntheticDataset(DURS, JModelConfig(**TINY), seed=4)
    jbatch = jax_collate([jds[i] for i in range(len(DURS))], (64,), len(DURS))
    np.savez(root / "batch.npz", **{f: x for f, x in zip(jbatch._fields, jbatch)
                                    if x is not None})
    batch = Batch(*[None if x is None else np.asarray(x) for x in jbatch])
    params, sds = {}, {}
    for fusion in FUSIONS:
        params[fusion] = _reg_offset(_jax_params(fusion, TINY)[1])
        sds[fusion] = state_dict_from_jax_params(params[fusion])
        torch.save(sds[fusion], root / f"init_{fusion}.pt")
    (root / "spec.json").write_text(json.dumps({"cases": _cases(), "test": TEST_CFG,
                                                "durs": DURS}))
    procs = gloo_world.start(WORKER, root, (2, 4))
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {}
        for fusion in FUSIONS:
            futures[("seq2", fusion)] = pool.submit(_jax_seq2_loss, fusion, params[fusion],
                                                    jbatch)
            for mesh_name in TP_MESHES:
                futures[(mesh_name, fusion)] = pool.submit(
                    _jax_mesh_step, fusion, params[fusion], jbatch, MESHES[mesh_name][1])
        one = {f: _one_process(f, sds[f], batch) for f in FUSIONS}
        dropout = {f: _one_process(f, sds[f], batch, dropout=DROPOUT) for f in FUSIONS}
        trainer = {f: _one_process_trainer(root, f, sds[f]) for f in FUSIONS}
        jax_refs = {k: f.result() for k, f in futures.items()}
    out = gloo_world.results(procs, root, timeout=400)
    return dict(root=root, batch=batch, sds=sds, jax=jax_refs, one=one, dropout=dropout,
                trainer=trainer, out=out)


def _results(runs, name: str) -> list:
    world = next(w for w, outs in runs["out"].items() if name in outs[0])
    return [o[name] for o in runs["out"][world]]


def _hold_params(got: dict, want: dict, lr: float = 1e-3, steps: int = STEPS) -> None:
    """Each tensor within 1e-5 of its largest element; a key bias (float32
    noise gradient) within lr a step."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        w, g = w.numpy(), got[k].numpy()
        atol = lr * steps * (1 + 1e-3) if k.endswith(".k.bias") else (
            1e-5 * (float(np.abs(w).max()) or 1.0))
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)


# -- 1. fault 1: a seq rank of a fusion variant holds whole rows ---------------------------


@pytest.mark.parametrize("fusion", FUSIONS)
def test_seq_ranks_train_a_variant_on_whole_rows(runs, fusion):
    """seq = 2 with the ring config: each rank stages the whole rows [4, 64]
    (the port's own staging, ``local_rows(..., seq=seq_split(...))``), and the
    step's loss and gradient norm equal one process and the JAX mesh loss.
    On the tree before the repair each rank held its 32 columns alone and
    attended within them: this test failed there, with [4, 32] staged (the
    first step's loss and gradient norm, cross: 1.7770 and 14.14 against
    1.5840 and 16.41 in one process, JAX's loss 1.5840; bottleneck: 1.4739
    and 9.617 against 1.9227 and 14.61, JAX's loss 1.9227)."""
    one, jax_loss = runs["one"][fusion], runs["jax"][("seq2", fusion)]
    for got in _results(runs, f"seq2_{fusion}"):
        assert got["local"] == [len(DURS), 64]
        hist = np.asarray(got["hist"])
        np.testing.assert_allclose(hist[:, 0], one["hist"][:, 0], rtol=1e-5)
        np.testing.assert_allclose(hist[:, 1], one["hist"][:, 1], rtol=1e-5)
        np.testing.assert_allclose(hist[0, 0], jax_loss, rtol=1e-5)
        _hold_params(got["params"], one["params"])


@pytest.mark.parametrize("fusion", FUSIONS)
def test_seq_ranks_probe_and_evaluate_a_variant_on_whole_rows(runs, fusion):
    """seq = 2 with the ring config: the val probe (``make_eval_step``, on
    the step's staging and through the Trainer's ``_device_batch``) and
    ``Trainer.evaluate`` equal one process; the evaluation keeps no ring."""
    one = runs["one"][fusion]
    for got in _results(runs, f"seq2_{fusion}"):
        for k in ("loss", "cls_loss"):
            np.testing.assert_allclose(got["probe"][k], one["probe"][k], rtol=1e-5, err_msg=k)
        assert got["probe"]["n_real"] == one["probe"]["n_real"] == len(DURS)
    want = runs["trainer"][fusion]
    assert want["eval"]["tiou/0.5"] > 0  # the decode keeps clips tIoU can score
    for got in _results(runs, f"trainer_seq2_{fusion}"):
        assert got["local"] == [len(DURS), 64] and not got["ring_eval"]
        np.testing.assert_allclose(got["val"], want["val"], rtol=1e-5)
        assert got["eval"].keys() == want["eval"].keys()
        for k, v in want["eval"].items():
            assert abs(got["eval"][k] - v) <= 1e-9, (k, got["eval"], want["eval"])


@pytest.mark.parametrize("fusion", FUSIONS)
def test_seq_split_keeps_a_variant_on_whole_rows(fusion):
    """``seq_split`` is False for a variant under the ring config, True for
    the concat MMCT; the inference pipeline keeps no ring for the variant."""
    mesh = _fake_mesh(seq=2)
    assert seq_split(ModelConfig(**{**TINY, "attention_impl": "ring"}), mesh)
    ring = _model(fusion, attention_impl="ring")
    assert not seq_split(ring, mesh)
    sd = build_model(_model(fusion), "cpu").state_dict()
    assert not InferencePipeline(ring, sd, TestConfig(**TEST_CFG), device="cpu",
                                 mesh=mesh).ring


@pytest.mark.parametrize("fusion", FUSIONS)
def test_no_eval_ring_warning_for_a_variant(fusion, tmp_path, caplog):
    """A variant has no ring to disable at eval: the Trainer does not warn."""
    cfg = Config(model=_model(fusion, attention_impl="ring"), train=TrainConfig(**_train_kw()),
                 test_cfg=TestConfig(**TEST_CFG))
    ds = SyntheticDataset(DURS, cfg.model, seed=1)
    with caplog.at_level(logging.WARNING, logger="repurpose_tpu_torch.train.loop"):
        trainer = Trainer(cfg, str(tmp_path), ds, device="cpu")
    trainer.close()
    assert not trainer.pipeline.ring
    assert "ring attention disabled" not in caplog.text


# -- 2. tensor parallelism: a variant whole on every model rank --------------------------


@pytest.mark.parametrize("mesh_name", TP_MESHES)
@pytest.mark.parametrize("fusion", FUSIONS)
def test_tensor_parallel_variant_step_equals_jax_and_one_process(runs, fusion, mesh_name):
    """model = 2 and data = 2 × model = 2: every rank's first step (loss and
    gradient norm) equals the JAX step with ``param_shardings`` on the same
    mesh, its losses and gradient norms one process's, and its parameters
    after the steps one process's."""
    one, want = runs["one"][fusion], runs["jax"][(mesh_name, fusion)]
    data = MESHES[mesh_name][1]["data"]
    for got in _results(runs, f"{mesh_name}_{fusion}"):
        assert got["local"] == [len(DURS) // data, 64]
        hist = np.asarray(got["hist"])
        np.testing.assert_allclose(hist[0], want, rtol=1e-5)
        np.testing.assert_allclose(hist, one["hist"], rtol=1e-5)
        _hold_params(got["params"], one["params"])


@pytest.mark.parametrize("fusion", FUSIONS)
def test_tensor_parallel_variant_dropout_keeps_the_model_ranks_equal(runs, fusion):
    """model = 2, dropout 0.1: the model ranks draw the same masks, so they
    end with equal parameters, bit for bit, and the one-process losses."""
    got = _results(runs, f"dropout_model2_{fusion}")
    for k, v in got[0]["params"].items():
        assert torch.equal(got[1]["params"][k], v), k
    want, undropped = runs["dropout"][fusion]["hist"], runs["one"][fusion]["hist"]
    assert not np.allclose(want[:, 0], undropped[:, 0], rtol=1e-3)  # the masks matter
    for g in got:
        np.testing.assert_allclose(np.asarray(g["hist"])[:, 0], want[:, 0], rtol=1e-5)


@pytest.mark.parametrize("fusion", FUSIONS)
def test_variant_checkpoint_from_data2_model2_restores_in_one_process(runs, fusion):
    """Rank 0 of data = 2 × model = 2 wrote the whole, reference-named state:
    it loads strictly in one process, at step 2, with one process's
    parameters, and the next step's loss is one process's third."""
    tc = TrainConfig(**_train_kw())
    model = build_model(_model(fusion), "cpu")
    model.set_dropout_generator(torch.Generator().manual_seed(tc.seed))
    restored, _ = Checkpointer(str(runs["root"] / f"ck_{fusion}")).restore(
        TrainState(model, make_optimizer(model, tc, 2)[0]))
    assert restored.step == STEPS
    one = runs["one"][fusion]
    _hold_params({k: v for k, v in restored.model.state_dict().items()}, one["params"])
    resumed = _one_process(fusion, None, runs["batch"], steps=1, state=restored)
    again = _one_process(fusion, runs["sds"][fusion], runs["batch"], steps=STEPS + 1)
    np.testing.assert_allclose(resumed["hist"][0], again["hist"][STEPS], rtol=1e-5)


@pytest.mark.parametrize("fusion", FUSIONS)
def test_variant_score_batch_at_model2_equals_one_process(runs, fusion):
    """``InferencePipeline(..., mesh=...)`` at model = 2 takes the variant's
    whole state dict and serves one process's clips."""
    b, tcfg = runs["batch"], TestConfig(**TEST_CFG)
    want = InferencePipeline(_model(fusion), runs["sds"][fusion], tcfg, device="cpu").score_batch(
        b.visual, b.audio, b.text, b.mask, b.durations)
    assert sum(len(w["scores"]) for w in want) > 0
    for got in _results(runs, f"score_model2_{fusion}"):
        assert not got["ring"]
        for g, w in zip(got["scored"], want, strict=True):
            np.testing.assert_array_equal(g["labels"], w["labels"])
            np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5)
            np.testing.assert_allclose(g["segments"], w["segments"], atol=1e-4)


# -- 3. the rules, without a world ---------------------------------------------------------


def _fake_mesh(**axes) -> Mesh:
    """A mesh of one process's view at coordinate 1 of each named axis
    (``size`` and ``coord`` only: no process group)."""
    sizes = dict(data=1, model=1, seq=1, pipe=1) | axes
    coords = {a: min(1, n - 1) for a, n in sizes.items()}
    return Mesh(sizes=sizes, coords=coords, rank=1, world=int(np.prod(list(sizes.values()))),
                device=torch.device("cpu"), backend=None)


@pytest.mark.parametrize("fusion,cls", [("cross", MMCTCross), ("bottleneck", MMCTBottleneck)])
def test_the_tensor_parallel_rule_matches_no_variant_parameter(fusion, cls):
    """At the flagship widths (configs/repurpose.yaml's d_model 512, 8 heads)
    and at TINY's, no parameter name of the variant is sharded."""
    for cfg in (ModelConfig(fusion=fusion, text_num_layers=3, cross_num_layers=3),
                _model(fusion)):
        with torch.device("meta"):
            names = [n for n, _ in cls(cfg).named_parameters()]
        assert len(names) > 20
        assert [n for n in names if param_sharding_rule(n) is not None] == []


@pytest.mark.parametrize("fusion", FUSIONS)
def test_build_model_builds_a_variant_whole_on_a_model_rank(fusion):
    """``build_model`` no longer raises at model > 1: model rank 1 of 2 holds
    the whole variant, with one process's weights."""
    got = build_model(_model(fusion), "cpu", seed=3, mesh=_fake_mesh(model=2))
    want = build_model(_model(fusion), "cpu", seed=3)
    assert type(got) is type(want)
    assert got.state_dict().keys() == want.state_dict().keys()
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k


@pytest.mark.parametrize("fusion", FUSIONS)
def test_build_model_refuses_a_variant_the_rule_would_shard(fusion, monkeypatch):
    """A later rename (or a wider rule) that lets ``param_sharding_rule``
    match a variant's parameter raises, with or without a mesh, rather than
    half-shard a model built whole."""
    rule = sharding.param_sharding_rule
    monkeypatch.setattr(sharding, "param_sharding_rule",
                        lambda n: "cols" if n.endswith(".out.weight") else rule(n))
    for mesh in (None, _fake_mesh(model=2)):
        with pytest.raises(ValueError, match="replicated over the model axis.*out.weight"):
            build_model(_model(fusion), "cpu", mesh=mesh)
    build_model(ModelConfig(**TINY), "cpu", mesh=_fake_mesh(model=2))  # the MMCT's rule is its own


@pytest.mark.parametrize("fusion", FUSIONS)
def test_pipeline_parallelism_keeps_refusing_a_variant(fusion):
    """pipe > 1 raises for a variant, as in JAX (``parallel/pipeline.py``)."""
    with pytest.raises(ValueError, match="pipeline supports the concat-fusion MMCT"):
        validate_pipeline(_model(fusion), _fake_mesh(pipe=2), 2, 4)
