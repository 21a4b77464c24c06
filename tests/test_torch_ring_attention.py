"""The port's ring attention (``ops/ring_attention.py``) and the ``seq``
axis of its model, Trainer and inference pipeline, on the CPU, against the
JAX package's.

Workers are gloo ranks (``tests/gloo_world.py``): worlds of 2 (``seq`` = 2)
and 4 (``seq`` = 4, and ``data`` = 2 × ``seq`` = 2), each rank holding its
``T / seq`` positions; this process computes the JAX references on the
8-device virtual mesh meanwhile (``ring_attention`` and its ``jax.grad``,
the JAX ``Trainer`` with ``attention_impl="ring"``) and the port's
one-process runs.

Tolerances (float32): the ring op against the JAX ring, the same folds in
the same order: outputs and gradients within 1e-5 of their tensor's
largest element; the ring train step against the one-process step: losses
rtol 1e-5, gradient norms rtol 1e-4, gradients within 1e-5 of each
tensor's largest element (sums over positions in another order); the
Trainer's epoch loss against the JAX Trainer rtol 1e-3
(``tests/test_torch_trainer.py``'s); the ring inference pipeline against
gather attention: scores atol 1e-5, segments atol 1e-4 (the JAX test's,
``tests/test_ring_attention.py:129``).
"""

import concurrent.futures
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repurpose_tpu.config import Config as JConfig
from repurpose_tpu.config import MeshConfig as JMeshConfig
from repurpose_tpu.config import ModelConfig as JModelConfig
from repurpose_tpu.config import TestConfig as JTestConfig
from repurpose_tpu.config import TrainConfig as JTrainConfig
from repurpose_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from repurpose_tpu.infer import InferencePipeline as JInferencePipeline
from repurpose_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from repurpose_tpu.parallel.mesh import create_mesh as jax_create_mesh
from repurpose_tpu.train.loop import Trainer as JTrainer
from repurpose_tpu.train.state import create_train_state
from repurpose_tpu_torch.config import ModelConfig, TestConfig, TrainConfig
from repurpose_tpu_torch.data.batching import Batch, collate
from repurpose_tpu_torch.infer import InferencePipeline
from repurpose_tpu_torch.models import build_model, state_dict_from_jax_params
from repurpose_tpu_torch.train.state import TrainState, make_optimizer
from repurpose_tpu_torch.train.step import batch_to_device, make_train_step
import gloo_world

# tests/test_ring_attention.py's model; the port on its kernel route
JMODEL = JModelConfig(vis_dim=8, aud_dim=12, text_dim=4, d_model=16, self_num_layers=2,
                      num_heads=2, d_ff=32, hidden_dim=8, compute_dtype="float32",
                      attention_impl="ring", matmul_precision="highest", dropout=0.0)
MODEL = ModelConfig(vis_dim=8, aud_dim=12, text_dim=4, d_model=16, self_num_layers=2,
                    num_heads=2, d_ff=32, hidden_dim=8, compute_dtype="float32",
                    attention_impl="ring", attn_softmax_dtype="float32", dropout=0.0)
TEST_CFG = dict(pre_nms_topk=64, pre_nms_thresh=0.2, duration_thresh=0.001,
                max_seg_per_min=2.0)
DURS = [60, 40, 64, 50, 30, 45, 55, 35]
# (b, t, h, dh) of the op's inputs; the masks, by name
OP_SHAPE = (2, 64, 4, 16)


def _masks() -> dict:
    tail = np.ones((2, 64), bool)
    tail[0, 40:] = False  # padding that spans shards
    tail[1, 55:] = False
    shard = np.ones((2, 64), bool)
    shard[:, 48:] = False  # at seq = 4 the last shard is all padding
    half = np.ones((2, 64), bool)
    half[:, 32:] = False  # at seq = 2 the last shard is all padding
    return {"tail": tail, "last_shard": shard, "last_half": half}


OP_CASES = [(n, mask) for n in (2, 4) for mask in ("tail", "last_shard", "last_half")]
# train-step cases: name -> (world, mesh axes)
STEP_CASES = {"seq2": (2, dict(data=1, seq=2)), "seq4": (4, dict(data=1, seq=4)),
              "data2_seq2": (4, dict(data=2, seq=2))}

WORKER = r'''
import json
import numpy as np
from repurpose_tpu_torch.config import Config, MeshConfig, ModelConfig, TestConfig, TrainConfig
from repurpose_tpu_torch.data.batching import Batch
from repurpose_tpu_torch.data.synthetic import SyntheticDataset
from repurpose_tpu_torch.infer import InferencePipeline
from repurpose_tpu_torch.models import build_model
from repurpose_tpu_torch.ops.ring_attention import ring_attention
from repurpose_tpu_torch.parallel.mesh import create_mesh
from repurpose_tpu_torch.parallel.sharding import local_rows
from repurpose_tpu_torch.train.loop import Trainer
from repurpose_tpu_torch.train.state import TrainState, make_optimizer
from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

spec = json.load(open(f"{root}/spec.json"))
MODEL = ModelConfig(**spec["model"])
SD = torch.load(f"{root}/init.pt", weights_only=True)
z = np.load(f"{root}/batch.npz")
BATCH = Batch(*[z[f] if f in z.files else None for f in Batch._fields])
OPS = np.load(f"{root}/op.npz")

out = {}
for case in spec["cases"][str(world)]:
    mesh = create_mesh(MeshConfig(**case["mesh"]), "gloo", "cpu")
    name = case["name"]
    if case["kind"] == "op":
        n, c = mesh.size("seq"), mesh.coord("seq")
        w = OPS["q"].shape[1] // n
        q, k, v = (torch.from_numpy(OPS[x][:, c * w : (c + 1) * w]).requires_grad_()
                   for x in "qkv")
        mask = torch.from_numpy(OPS[case["mask"]][:, c * w : (c + 1) * w])
        o = ring_attention(q, k, v, mask, mesh)
        (o ** 2).sum().backward()
        out[name] = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    elif case["kind"] == "step":
        tc = TrainConfig(**case["train"])
        model = build_model(MODEL, "cpu", mesh=mesh)
        model.load_state_dict(SD)
        opt, schedule = make_optimizer(model, tc, 2, mesh)
        state = TrainState(model, opt, mesh=mesh)
        step = make_train_step(MODEL, tc, schedule, mesh)
        b = batch_to_device(local_rows(BATCH, mesh, seq=True), "cpu")
        hist = []
        for i in range(2):
            m = step(state, b)
            hist.append([float(m["loss"]), float(m["grad_norm"])])
            if i == 0:
                grads = {k: p.grad.clone() for k, p in model.named_parameters()
                         if p.grad is not None}
        out[name] = {"hist": hist, "grads": grads, "local": list(b.visual.shape)}
    elif case["kind"] == "eval":
        pipe = InferencePipeline(MODEL, SD, TestConfig(**case["test"]), device="cpu",
                                 mesh=mesh)
        rows = local_rows(BATCH, mesh)
        out[name] = {"ring": pipe.ring, "scored": pipe.score_batch(
            rows.visual, rows.audio, rows.text, rows.mask, rows.durations)}
    elif case["kind"] == "trainer":
        cfg = Config(model=MODEL, train=TrainConfig(**case["train"]),
                     mesh=MeshConfig(**case["mesh"]), test_cfg=TestConfig(**case["test"]))
        ds = SyntheticDataset(case["durs"], MODEL, seed=1)
        trainer = Trainer(cfg, f"{root}/{name}", ds, val_ds=ds, test_ds=ds,
                          init_params=torch.load(f"{root}/init.pt", weights_only=True),
                          device="cpu")
        summary = trainer.fit()
        out[name] = {"final_loss": summary["final_loss"], "step": summary["step"],
                     "val": trainer._val_probe(), "eval": trainer.evaluate(),
                     "ring_eval": trainer.pipeline.ring}
        trainer.close()
    dist.barrier()
torch.save(out, f"{root}/out{world}_rank{rank}.pt")
dist.destroy_process_group()
'''


def _jax_op(ops: dict, n: int, mask_name: str) -> dict:
    """The JAX ring's output and ``jax.grad`` of sum(out ** 2) at seq = n."""
    mesh = jax_create_mesh(JMeshConfig(data=1, seq=n))
    sh = NamedSharding(mesh, P("data", "seq", None, None))
    msh = NamedSharding(mesh, P("data", "seq"))
    q, k, v = (jax.device_put(jnp.asarray(ops[x]), sh) for x in "qkv")
    mask = jax.device_put(jnp.asarray(ops[mask_name]), msh)
    f = lambda a, b, c: jax_ring_attention(a, b, c, mask, mesh)  # noqa: E731
    out = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(f(a, b, c) ** 2), argnums=(0, 1, 2)))(
        q, k, v)
    return {"out": np.asarray(out), **{f"d{x}": np.asarray(g) for x, g in zip("qkv", grads)}}


def _train_cfg(**kw) -> dict:
    return dict(batch_size=8, buckets=(64,), epochs=1, lr=1e-3, loss_norm="batch_size") | kw


def _trainer_train() -> dict:
    return dict(batch_size=2, buckets=(64,), epochs=1, eval_freq=100, intra_epoch_eval_freq=0,
                save_epochs=100, lr=1e-3, loss_norm="batch_size")


def _jax_trainer(root, params) -> dict:
    jcfg = JConfig(model=JMODEL, train=JTrainConfig(**_trainer_train()),
                   mesh=JMeshConfig(data=1, seq=2), test_cfg=JTestConfig(**TEST_CFG))
    trainer = JTrainer(jcfg, str(root / "jax_trainer"),
                       JSyntheticDataset(DURS, JMODEL, seed=1), init_params=params)
    summary = trainer.fit()
    trainer.close()
    return {"final_loss": summary["final_loss"], "step": int(trainer.state.step)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ring")
    rng = np.random.default_rng(1234)
    ops = {x: rng.normal(0, 1, OP_SHAPE).astype(np.float32) for x in "qkv"} | _masks()
    np.savez(root / "op.npz", **ops)
    jmodel = dataclasses.replace(JMODEL, attention_impl="xla")
    jstate, _, _ = create_train_state(jmodel, JTrainConfig(**_trainer_train()), 2,
                                      jax.random.key(0))
    params = jax.device_get(jstate.params)
    sd = state_dict_from_jax_params(params)
    torch.save(sd, root / "init.pt")
    from repurpose_tpu_torch.data.synthetic import SyntheticDataset

    batch = collate([SyntheticDataset(DURS, MODEL, seed=4)[i] for i in range(8)], (64,), 8)
    np.savez(root / "batch.npz", **{f: x for f, x in zip(batch._fields, batch) if x is not None})

    cases = {"2": [], "4": []}
    for n, mask in OP_CASES:
        cases[str(n)].append(dict(kind="op", name=f"op_seq{n}_{mask}", mesh=dict(data=1, seq=n),
                                  mask=mask))
    for name, (world, axes) in STEP_CASES.items():
        cases[str(world)].append(dict(kind="step", name=name, mesh=axes,
                                      train=_train_cfg(batch_size=8 // axes["data"])))
    cases["2"].append(dict(kind="eval", name="eval", mesh=dict(data=1, seq=2), test=TEST_CFG))
    cases["2"].append(dict(kind="trainer", name="trainer", mesh=dict(data=1, seq=2),
                           train=_trainer_train(), test=TEST_CFG, durs=DURS))
    (root / "spec.json").write_text(json.dumps({"model": dataclasses.asdict(MODEL),
                                                "cases": cases}))
    procs = gloo_world.start(WORKER, root, (2, 4))
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        op_refs = {f"op_seq{n}_{mask}": pool.submit(_jax_op, ops, n, mask)
                   for n, mask in OP_CASES}
        trainer = pool.submit(_jax_trainer, root, params)
        jax_refs = {k: f.result() for k, f in (op_refs | {"trainer": trainer}).items()}
    out = gloo_world.results(procs, root, timeout=400)
    return dict(root=root, sd=sd, batch=batch, params=params, ops=ops, jax=jax_refs, out=out)


def _results(runs, name: str) -> list:
    world = next(w for w, outs in runs["out"].items() if name in outs[0])
    return [o[name] for o in runs["out"][world]]


def _close(got: np.ndarray, want: np.ndarray, rel: float = 1e-5, err_msg: str = "") -> None:
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * (float(np.abs(want).max()) or 1.0),
                               err_msg=err_msg)


def _whole(parts: list, key: str) -> np.ndarray:
    """The ranks' ``key`` shards, each rank's columns, side by side."""
    return np.concatenate([p[key].numpy() for p in parts], axis=1)


# -- 1. the ring op against the JAX ring_attention and its jax.grad ----------------------


@pytest.mark.parametrize("n,mask", OP_CASES)
def test_ring_forward_and_gradients_match_the_jax_ring(runs, n, mask):
    """At seq = 2 and 4, with padding that spans shards and with a shard
    whose keys are all masked: the output and dq / dk / dv of every rank's
    positions are the JAX ring's (tests/test_ring_attention.py:31-98); the
    outputs are finite and masked keys get exactly zero dk / dv (:171)."""
    name = f"op_seq{n}_{mask}"
    got, want = _results(runs, name), runs["jax"][name]
    valid = runs["ops"][mask]
    for key in ("out", "dq", "dk", "dv"):
        whole = _whole(got, key)
        assert np.isfinite(whole).all(), key
        _close(whole[valid], want[key][valid], err_msg=key)
        if key in ("dk", "dv"):
            assert np.abs(whole[~valid]).max() == 0.0, key


# -- 2. the model's seq axis: train steps, eval, the Trainer ------------------------------


def _one_process(runs) -> tuple:
    mc = dataclasses.replace(MODEL, attention_impl="auto")
    tc = TrainConfig(**_train_cfg())
    model = build_model(mc, "cpu")
    model.load_state_dict(runs["sd"])
    opt, schedule = make_optimizer(model, tc, 2)
    state = TrainState(model, opt)
    step = make_train_step(mc, tc, schedule)
    dev = batch_to_device(Batch(*runs["batch"]), "cpu")
    hist, grads = [], None
    for i in range(2):
        m = step(state, dev)
        hist.append([float(m["loss"]), float(m["grad_norm"])])
        if i == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    return np.asarray(hist), grads


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_ring_train_step_equals_one_process(runs, name):
    """Each rank its T / seq columns of its rows (the PE at the global
    positions): the loss sums, the gradients and the norm summed over seq
    (and data) are the one-process step's on whole rows."""
    hist, grads = _one_process(runs)
    axes = STEP_CASES[name][1]
    for got in _results(runs, name):
        assert got["local"][:2] == [8 // axes["data"], 64 // axes["seq"]]
        np.testing.assert_allclose(np.asarray(got["hist"])[:, 0], hist[:, 0], rtol=1e-5)
        np.testing.assert_allclose(np.asarray(got["hist"])[:, 1], hist[:, 1], rtol=1e-4)
        assert got["grads"].keys() == grads.keys()
        for k, v in grads.items():
            _close(got["grads"][k].numpy(), v.numpy(), err_msg=k)


def test_ring_inference_pipeline_matches_gather_attention(runs):
    """The pipeline keeps the ring live on seq = 2, gathers the scores over
    seq before the decode, and keeps the clips of the gather-attention
    pipelines, the port's and the JAX one (tests/test_ring_attention.py:129)."""
    batch, tcfg = runs["batch"], TestConfig(**TEST_CFG)
    args = (batch.visual, batch.audio, batch.text, batch.mask, batch.durations)
    port = InferencePipeline(dataclasses.replace(MODEL, attention_impl="auto"), runs["sd"],
                             tcfg, device="cpu").score_batch(*args)
    jax_pipe = JInferencePipeline(dataclasses.replace(JMODEL, attention_impl="xla"),
                                  runs["params"], JTestConfig(**TEST_CFG))
    jax_res = jax_pipe.score_batch(*args)
    assert sum(len(w["scores"]) for w in port) > 0
    for got in _results(runs, "eval"):
        assert got["ring"]
        for g, w, j in zip(got["scored"], port, jax_res):
            assert len(g["scores"]) == len(w["scores"]) == len(j["scores"])
            np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5)
            np.testing.assert_allclose(g["segments"], w["segments"], atol=1e-4)
            np.testing.assert_allclose(g["scores"], j["scores"], atol=1e-5)


def test_ring_trainer_matches_the_jax_trainer(runs):
    """An epoch through the Trainer with ring attention on seq = 2 against
    the JAX Trainer's on the same mesh; the ring stays live at eval, the
    val probe sums over seq, and both ranks agree."""
    want = runs["jax"]["trainer"]
    got = _results(runs, "trainer")
    for g in got:
        assert g["ring_eval"] and g["step"] == want["step"] > 0
        np.testing.assert_allclose(g["final_loss"], want["final_loss"], rtol=1e-3)
    assert got[0]["val"] == got[1]["val"] and got[0]["eval"] == got[1]["eval"]


def test_ring_needs_a_mesh_and_refuses_packing():
    model = build_model(MODEL, "cpu")
    x = torch.zeros(1, 8, MODEL.vis_dim), torch.zeros(1, 8, MODEL.aud_dim)
    with pytest.raises(ValueError, match="needs build_model"):
        model(*x, torch.zeros(1, 8, MODEL.text_dim), torch.ones(1, 8, dtype=torch.bool))
    from repurpose_tpu_torch.config import Config
    from repurpose_tpu_torch.data.synthetic import SyntheticDataset
    from repurpose_tpu_torch.train.loop import Trainer

    cfg = Config(model=MODEL, train=TrainConfig(pack_sequences=True, buckets=(64,)))
    with pytest.raises(ValueError, match="pack_sequences is not supported with ring"):
        Trainer(cfg, "/nonexistent", SyntheticDataset([30], MODEL, seed=0), device="cpu")
