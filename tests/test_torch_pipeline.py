"""The port's pipeline parallelism (``parallel/pipeline.py``, GPipe, and
``parallel/pipeline_1f1b.py``) on the CPU, against the JAX package's.

Workers are gloo ranks (``tests/gloo_world.py``): a world of 2 (``pipe`` =
2) and one of 4 (``data`` = 2 × ``pipe`` = 2, and ``pipe`` = 4), each
running its cases on converted JAX weights (``state_dict_from_jax_params``);
this process computes the JAX references on the 8-device virtual mesh
meanwhile (``pipeline_forward``, ``make_1f1b_train_step`` and the
gradients of its ``_loss_and_grads``, the JAX ``Trainer``) and the port's
one-process runs.

Tolerances (float32 throughout, dropout 0, the JAX side at "highest"
precision): the forward's outputs atol 2e-5 (the JAX pipeline's own against
its unpipelined model); losses rtol 1e-5 and gradient norms rtol 1e-4 (the
JAX 1F1B tests'); every gradient within 1e-5 of its tensor's largest
element (sums over rows in another order); parameters after two Adam
steps atol 5e-4 (``tests/test_pipeline.py``: Adam moves a gradient that is
float32 noise, as the key bias's, by up to lr a step either way); the
Trainer's epoch loss rtol 1e-3 (``tests/test_torch_trainer.py``'s).
"""

import concurrent.futures
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repurpose_tpu.config import Config as JConfig
from repurpose_tpu.config import MeshConfig as JMeshConfig
from repurpose_tpu.config import ModelConfig as JModelConfig
from repurpose_tpu.config import TestConfig as JTestConfig
from repurpose_tpu.config import TrainConfig as JTrainConfig
from repurpose_tpu.data.batching import collate as jax_collate
from repurpose_tpu.data.batching import pack_batch as jax_pack_batch
from repurpose_tpu.data.batching import plan_packing as jax_plan_packing
from repurpose_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from repurpose_tpu.parallel.mesh import create_mesh as jax_create_mesh
from repurpose_tpu.parallel.pipeline import pipeline_forward as jax_pipeline_forward
from repurpose_tpu.parallel.pipeline import split_pipeline_params as jax_split
from repurpose_tpu.parallel.pipeline import unstack_layer_params
from repurpose_tpu.parallel.pipeline_1f1b import _loss_and_grads as jax_loss_and_grads
from repurpose_tpu.parallel.pipeline_1f1b import make_1f1b_train_step as jax_1f1b_step
from repurpose_tpu.parallel.sharding import make_global_batch
from repurpose_tpu.train.loop import Trainer as JTrainer
from repurpose_tpu.train.state import create_train_state
from repurpose_tpu_torch.config import ModelConfig, TestConfig, TrainConfig
from repurpose_tpu_torch.data.batching import Batch
from repurpose_tpu_torch.models import build_model, state_dict_from_jax_params
from repurpose_tpu_torch.parallel.mesh import Mesh
from repurpose_tpu_torch.parallel.pipeline import (
    merge_pipeline_params,
    split_pipeline_params,
    validate_pipeline,
)
from repurpose_tpu_torch.train.state import TrainState, make_optimizer
from repurpose_tpu_torch.train.step import batch_to_device, make_train_step
import gloo_world

# tests/test_pipeline.py's CFG; the port on its kernel route (the plain
# versions on CPU tensors), float32 interior
JCFG = JModelConfig(vis_dim=16, aud_dim=24, text_dim=8, d_model=32, self_num_layers=4,
                    num_heads=4, d_ff=64, hidden_dim=16, compute_dtype="float32",
                    attention_impl="xla", matmul_precision="highest", dropout=0.0)
CFG = ModelConfig(vis_dim=16, aud_dim=24, text_dim=8, d_model=32, self_num_layers=4,
                  num_heads=4, d_ff=64, hidden_dim=16, compute_dtype="float32",
                  attention_impl="auto", attn_softmax_dtype="float32", dropout=0.0)
PARAM_ATOL = 5e-4
# the Trainer cases: tests/test_pipeline_1f1b.py's model and packed config
TRAINER_MODEL = dataclasses.replace(CFG, self_num_layers=2, vis_dim=8, aud_dim=12, text_dim=4,
                                    d_model=16, num_heads=2, d_ff=32, hidden_dim=8)
TRAINER_DURS = [60, 40, 70, 50, 90, 30, 80, 20]
PIPE2 = dict(data=1, pipe=2)

WORKER = r'''
import dataclasses
import json
import numpy as np
from repurpose_tpu_torch.config import Config, MeshConfig, ModelConfig, TestConfig, TrainConfig
from repurpose_tpu_torch.data.batching import Batch
from repurpose_tpu_torch.data.synthetic import SyntheticDataset
from repurpose_tpu_torch.models import build_model
from repurpose_tpu_torch.parallel.mesh import create_mesh
from repurpose_tpu_torch.parallel.pipeline import (
    create_pipeline_train_state, gather_pipeline_state_dict, pipeline_forward,
    pipeline_grads_by_name, stage_state_dict)
from repurpose_tpu_torch.parallel.pipeline_1f1b import make_1f1b_train_step
from repurpose_tpu_torch.parallel.sharding import local_rows
from repurpose_tpu_torch.train.loop import Trainer
from repurpose_tpu_torch.train.state import TrainState, make_optimizer
from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

spec = json.load(open(f"{root}/spec.json"))
MODEL = ModelConfig(**spec["model"])
SD = torch.load(f"{root}/init.pt", weights_only=True)


def batch(name):
    z = np.load(f"{root}/{name}.npz")
    return Batch(*[z[f] if f in z.files else None for f in Batch._fields])


out = {}
for case in spec["cases"][str(world)]:
    mesh = create_mesh(MeshConfig(**case["mesh"]), "gloo", "cpu")
    if case["kind"] == "forward":
        model = build_model(MODEL, "cpu")
        model.load_state_dict(SD)
        b = batch_to_device(local_rows(batch(case["batch"]), mesh), "cpu")
        with torch.no_grad():
            o = pipeline_forward(model, mesh, case["m"], b.visual, b.audio, b.text, b.mask,
                                 b.seg_ids, b.positions)
        out[case["name"]] = {"cls": o.cls_logits, "offsets": o.offsets}
    elif case["kind"] == "step":
        tc = TrainConfig(**case["train"])
        split = case["split"]
        if split:
            state, schedule = create_pipeline_train_state(MODEL, tc, mesh, 2, device="cpu")
            state.model.load_state_dict(stage_state_dict(SD, MODEL, mesh))
        else:
            model = build_model(MODEL, "cpu", mesh=mesh)
            model.load_state_dict(SD)
            model.set_dropout_generator(torch.Generator().manual_seed(tc.seed))
            opt, schedule = make_optimizer(model, tc, 2, mesh)
            state = TrainState(model, opt, mesh=mesh)
        real_batch, sizes = dist.batch_isend_irecv, []
        if case.get("nccl_hops"):
            # Mesh.hop's NCCL branch (one batch a hop) on gloo's batch, which
            # refuses an empty list as NCCL's does
            mesh = dataclasses.replace(mesh, backend="nccl")

            def spy(ops):
                sizes.append(len(ops))
                return real_batch(ops)

            dist.batch_isend_irecv = spy
        if tc.pipeline_schedule == "1f1b":
            step = make_1f1b_train_step(MODEL, tc, schedule, mesh, tc.pipeline_microbatches,
                                        split_layout=split, zero1=tc.shard_opt_state)
        else:
            step = make_train_step(MODEL, tc, schedule, mesh)
        b = batch_to_device(local_rows(batch(case["batch"]), mesh), "cpu")
        hist, grads = [], None
        for i in range(case["steps"]):
            m = step(state, b, per_layer_grad_norms=True, grad_histograms=i == 0)
            hist.append([float(m["loss"]), float(m["grad_norm"])])
            if i == 0:
                grads = {k: v.clone() for k, v in pipeline_grads_by_name(state.model,
                                                                         mesh).items()}
                telemetry = {k: m[k] for k in ("grad_norms/stacked", "hist/grads/counts")}
        dist.batch_isend_irecv = real_batch
        params = (gather_pipeline_state_dict(state.model, mesh) if split
                  else state.gathered()[0])
        out[case["name"]] = {"hist": hist, "grads": grads, "params": params,
                             "telemetry": telemetry, "batches": sizes}
    elif case["kind"] == "trainer":
        cfg = Config(model=ModelConfig(**case["model"]), train=TrainConfig(**case["train"]),
                     mesh=MeshConfig(**case["mesh"]), test_cfg=TestConfig(**case["test"]))
        init = torch.load(f"{root}/trainer_init.pt", weights_only=True)
        ds = SyntheticDataset(case["durs"], cfg.model, seed=3)
        trainer = Trainer(cfg, f"{root}/{case['name']}", ds, val_ds=ds, test_ds=ds,
                          init_params=init, device="cpu")
        summary = trainer.fit()
        out[case["name"]] = {"final_loss": summary["final_loss"], "step": summary["step"],
                             "val": trainer._val_probe(), "eval": trainer.evaluate(),
                             "ckpt": trainer.checkpointer.restore_model()}
        trainer.close()
    dist.barrier()
torch.save(out, f"{root}/out{world}_rank{rank}.pt")
dist.destroy_process_group()
'''


def _batches() -> dict:
    """numpy global batches: tests/test_pipeline*.py's unpacked [8, 32] and
    packed [4, 64], and a packed [8, 32] for the forward."""
    ds = JSyntheticDataset([32 - i for i in range(8)], JCFG, seed=0)
    unpacked = jax_collate([ds[i] for i in range(8)], (32,), 8)
    durs = [40, 20, 30, 25, 35, 15, 45, 10]
    pds = JSyntheticDataset(durs, JCFG, seed=3)
    packed = jax_pack_batch([pds[i] for i in range(8)], jax_plan_packing(durs, 64, 4)[0], 64, 4)
    t = 32
    seg = np.where(np.arange(t) < 20, 0, 1)[None].repeat(8, 0).astype(np.int32)
    pos = np.where(np.arange(t) < 20, np.arange(t), np.arange(t) - 20)[None].repeat(8, 0)
    fwd_packed = unpacked._replace(mask=np.ones((8, t), bool), seg_ids=seg,
                                   positions=pos.astype(np.int32))
    six = type(unpacked)(*[None if x is None else x[:6] for x in unpacked])
    return {"unpacked": unpacked, "packed": packed, "fwd_packed": fwd_packed, "six": six}


def _tc(packed: bool, m: int = 2, schedule: str = "1f1b", data: int = 1, **kw) -> dict:
    rows = 4 if packed else 8
    return dict(batch_size=rows // data, buckets=(64,) if packed else (32,), epochs=1,
                lr=1e-3, pack_sequences=packed,
                loss_norm="batch_size" if packed else "config_batch_size",
                pipeline_microbatches=m, pipeline_schedule=schedule, **kw)


# name -> (mesh, batch, train config kwargs (per data rank), split layout, steps)
STEPS = {
    "1f1b_m2": (PIPE2, "unpacked", _tc(False), False, 2),
    "1f1b_m1": (PIPE2, "unpacked", _tc(False, m=1), False, 1),
    "1f1b_m4": (PIPE2, "unpacked", _tc(False, m=4), False, 1),
    "gpipe_m2": (PIPE2, "unpacked", _tc(False, schedule="gpipe"), False, 2),
    "1f1b_packed": (PIPE2, "packed", _tc(True), False, 1),
    "gpipe_packed": (PIPE2, "packed", _tc(True, schedule="gpipe"), False, 1),
    "gpipe_split": (PIPE2, "unpacked", _tc(False, schedule="gpipe"), True, 2),
    "1f1b_split": (PIPE2, "unpacked", _tc(False), True, 2),
    "pipe4_m3": (dict(data=1, pipe=4), "six", _tc(False, m=3) | {"batch_size": 6}, False, 1),
    "data2_pipe2": (dict(data=2, pipe=2), "packed", _tc(True, data=2, shard_opt_state=True),
                    False, 2),
}
WORLD = lambda mesh: mesh["data"] * mesh["pipe"]  # noqa: E731
# the NCCL branch of Mesh.hop: name -> the case it must equal bit for bit
NCCL_HOPS = {"gpipe_m2_nccl": "gpipe_m2", "1f1b_m2_nccl": "1f1b_m2", "pipe4_m3_nccl": "pipe4_m3"}
# name -> (JAX mesh, batch, microbatches, steps, grads too)
JAX_STEPS = {"1f1b_m2": (PIPE2, "unpacked", 2, 2, True), "1f1b_m1": (PIPE2, "unpacked", 1, 1, False),
             "1f1b_m4": (PIPE2, "unpacked", 4, 1, False),
             "1f1b_packed": (PIPE2, "packed", 2, 1, True),
             "pipe4_m3": (dict(data=1, pipe=4), "six", 3, 1, False),
             "data2_pipe2": (dict(data=2, pipe=2), "packed", 2, 2, False)}


def _jax_forward(params, batch, m: int, packed: bool) -> np.ndarray:
    mesh = jax_create_mesh(JMeshConfig(**PIPE2))
    kw = dict(seg_ids=batch.seg_ids, positions=batch.positions) if packed else {}
    out = jax.jit(lambda p, *xs: jax_pipeline_forward(JCFG, mesh, m, p, *xs, **kw))(
        params, batch.visual, batch.audio, batch.text, batch.mask)
    return np.asarray(out.cls_logits), np.asarray(out.offsets)


def _jax_steps(params, batch, mesh_axes: dict, m: int, steps: int, grads: bool,
               tc_kw: dict) -> dict:
    """The JAX 1F1B step's history and parameters, and with ``grads`` the
    gradients of its first step (its ``_loss_and_grads``), reference-named."""
    jtc = JTrainConfig(**(tc_kw | {"batch_size": batch.mask.shape[0]}))
    state, tx, sched = create_train_state(JCFG, jtc, 2, jax.random.key(1))
    state = dataclasses.replace(state, params=params)
    mesh = jax_create_mesh(JMeshConfig(**mesh_axes))
    dev = make_global_batch(batch, mesh)
    out = {}
    if grads:
        sp = jax_split(params, JCFG.self_num_layers)
        _, g_lay, g_rest, _ = jax.jit(lambda lay, rest, b: jax_loss_and_grads(
            JCFG, jtc, mesh, m, lay, rest, b, jax.random.key(7)))(sp["layers"], sp["rest"], dev)
        tree = dict(jax.device_get(g_rest))
        tree["encoder"] = unstack_layer_params(jax.device_get(g_lay), JCFG.self_num_layers)
        out["grads"] = state_dict_from_jax_params(tree)
    step = jax_1f1b_step(JCFG, jtc, tx, sched, mesh=mesh, n_microbatches=m, donate=False)
    hist = []
    for _ in range(steps):
        state, metrics = step(state, dev, jax.random.key(7))
        hist.append([float(metrics["loss"]), float(metrics["grad_norm"])])
    out["hist"] = np.asarray(hist)
    out["params"] = state_dict_from_jax_params(jax.device_get(state.params))
    return out


def _jax_trainer(root, init_params) -> dict:
    jcfg = JConfig(
        model=JModelConfig(**dataclasses.asdict(TRAINER_MODEL) | {
            "attention_impl": "xla", "matmul_precision": "highest"}),
        train=JTrainConfig(**_trainer_train()), mesh=JMeshConfig(**PIPE2),
        test_cfg=JTestConfig(pre_nms_topk=16))
    trainer = JTrainer(jcfg, str(root / "jax_trainer"),
                       JSyntheticDataset(TRAINER_DURS, jcfg.model, seed=3),
                       init_params=init_params)
    summary = trainer.fit()
    trainer.close()
    return {"final_loss": summary["final_loss"], "step": int(trainer.state.step)}


def _trainer_train() -> dict:
    return dict(batch_size=4, buckets=(128,), epochs=1, eval_freq=100, intra_epoch_eval_freq=0,
                save_epochs=1, lr=1e-3, pack_sequences=True, loss_norm="batch_size",
                pipeline_microbatches=2, pipeline_schedule="1f1b")


def _one_process(sd, batch, tc_kw: dict, steps: int, model=CFG):
    """The port's one-process run: (history, first step's gradients, state)."""
    tc = TrainConfig(**(tc_kw | {"batch_size": batch.mask.shape[0], "shard_opt_state": False}))
    m = build_model(model, "cpu")
    m.load_state_dict(sd)
    opt, schedule = make_optimizer(m, tc, 2)
    state = TrainState(m, opt)
    step = make_train_step(model, tc, schedule)
    dev = batch_to_device(Batch(*batch), "cpu")
    hist, grads = [], None
    for i in range(steps):
        metrics = step(state, dev, per_layer_grad_norms=True, grad_histograms=i == 0)
        hist.append([float(metrics["loss"]), float(metrics["grad_norm"])])
        if i == 0:
            grads = {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}
            telemetry = {k: metrics[k] for k in ("grad_norms/stacked", "hist/grads/counts")}
    return np.asarray(hist), grads, state, telemetry


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    batches = _batches()
    jstate, _, _ = create_train_state(JCFG, JTrainConfig(**_tc(False)), 2, jax.random.key(1))
    params = jax.device_get(jstate.params)
    sd = state_dict_from_jax_params(params)
    torch.save(sd, root / "init.pt")
    for name, b in batches.items():
        np.savez(root / f"{name}.npz", **{f: x for f, x in zip(b._fields, b) if x is not None})
    jt_model = JModelConfig(**dataclasses.asdict(TRAINER_MODEL) | {"attention_impl": "xla"})
    jt_state, _, _ = create_train_state(jt_model, JTrainConfig(**_trainer_train()), 2,
                                        jax.random.key(5))
    trainer_params = jax.device_get(jt_state.params)
    torch.save(state_dict_from_jax_params(trainer_params), root / "trainer_init.pt")

    cases = {"2": [], "4": []}
    for name, (mesh, batch, tc_kw, split, steps) in STEPS.items():
        cases[str(WORLD(mesh))].append(dict(kind="step", name=name, mesh=mesh, batch=batch,
                                            train=tc_kw, split=split, steps=steps))
    for name, like in NCCL_HOPS.items():
        mesh, batch, tc_kw, split, _ = STEPS[like]
        cases[str(WORLD(mesh))].append(dict(kind="step", name=name, mesh=mesh, batch=batch,
                                            train=tc_kw, split=split, steps=1, nccl_hops=True))
    for name, batch in (("fwd_unpacked", "unpacked"), ("fwd_packed", "fwd_packed")):
        cases["2"].append(dict(kind="forward", name=name, mesh=PIPE2, batch=batch, m=2))
    for name, sched in (("trainer_1f1b", "1f1b"), ("trainer_gpipe", "gpipe")):
        cases["2"].append(dict(
            kind="trainer", name=name, mesh=PIPE2, model=dataclasses.asdict(TRAINER_MODEL),
            train=_trainer_train() | {"pipeline_schedule": sched}, durs=TRAINER_DURS,
            test=dataclasses.asdict(TestConfig(pre_nms_topk=16))))
    (root / "spec.json").write_text(json.dumps({"model": dataclasses.asdict(CFG),
                                                "cases": cases}))
    procs = gloo_world.start(WORKER, root, (2, 4))
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        fwd = {name: pool.submit(_jax_forward, params, batches[b], 2, b != "unpacked")
               for name, b in (("fwd_unpacked", "unpacked"), ("fwd_packed", "fwd_packed"))}
        steps = {name: pool.submit(_jax_steps, params, batches[b], mesh, m, n, g,
                                   STEPS[name][2])
                 for name, (mesh, b, m, n, g) in JAX_STEPS.items()}
        trainer = pool.submit(_jax_trainer, root, trainer_params)
        jax_refs = {k: f.result() for k, f in (fwd | steps | {"trainer": trainer}).items()}
    out = gloo_world.results(procs, root, timeout=400)
    return dict(root=root, sd=sd, batches=batches, jax=jax_refs, out=out,
                trainer_sd=torch.load(root / "trainer_init.pt", weights_only=True))


def _results(runs, name: str) -> list:
    world = next(w for w, outs in runs["out"].items() if name in outs[0])
    return [o[name] for o in runs["out"][world]]


def _close_grads(got: dict, want: dict, rel: float = 1e-5) -> None:
    want = {k: v for k, v in want.items() if k != "positional_encoding.pe"}  # a buffer
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = torch.as_tensor(np.asarray(w)).float()
        scale = float(w.abs().max()) or 1.0
        np.testing.assert_allclose(got[k].float().numpy(), w.numpy(), rtol=0, atol=rel * scale,
                                   err_msg=k)


def _close_params(got: dict, want: dict, steps: int, lr: float = 1e-3) -> None:
    """Parameters after ``steps`` Adam steps within ``PARAM_ATOL``, but for
    the key bias (the middle third of each ``in_proj_bias``): softmax
    cancels it, so its gradient is float32 noise whose sign the summation
    order decides, and Adam moves it by lr either way: within 2 lr a step."""
    for k, v in want.items():
        g, w = got[k].numpy(), np.asarray(v)
        atol = np.full(w.shape, PARAM_ATOL)
        if k.endswith("in_proj_bias"):
            d = w.shape[0] // 3
            atol[d : 2 * d] = 2 * lr * steps
        assert (np.abs(g - w) <= atol).all(), (k, float(np.abs(g - w).max()))


# -- 1. the GPipe forward against the JAX pipeline_forward ------------------------------


@pytest.mark.parametrize("name", ["fwd_unpacked", "fwd_packed"])
def test_gpipe_forward_matches_the_jax_pipeline_forward(runs, name):
    """Every rank of the pipe axis returns the whole batch's outputs, those
    of the JAX pipelined forward at every real position
    (tests/test_pipeline.py:58, :69)."""
    want_cls, want_off = runs["jax"][name]
    valid = runs["batches"]["unpacked" if name == "fwd_unpacked" else name].mask
    for got in _results(runs, name):
        # padded query rows hold finite values that no consumer reads, and
        # the port's attention fills them otherwise than mha_xla
        np.testing.assert_allclose(got["cls"].numpy()[valid], want_cls[valid], atol=2e-5)
        np.testing.assert_allclose(got["offsets"].numpy()[valid], want_off[valid], atol=2e-5)


# -- 2. the 1F1B step against the JAX make_1f1b_train_step -------------------------------


@pytest.mark.parametrize("name", list(JAX_STEPS))
def test_1f1b_step_matches_the_jax_1f1b_step(runs, name):
    """Loss and gradient norm of every step (M = 1, 2, 4 on two stages; an
    odd M = 3 on four; a packed batch; data = 2 × pipe = 2 with ZeRO-1),
    and the parameters after the steps."""
    want = runs["jax"][name]
    for rank, got in enumerate(_results(runs, name)):
        hist = np.asarray(got["hist"])
        np.testing.assert_allclose(hist[:, 0], want["hist"][:, 0], rtol=1e-5,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(hist[:, 1], want["hist"][:, 1], rtol=1e-4,
                                   err_msg=f"rank {rank}")
        _close_params(got["params"], want["params"], len(want["hist"]))


@pytest.mark.parametrize("name", [n for n, c in JAX_STEPS.items() if c[4]])
def test_1f1b_gradients_match_the_jax_schedule(runs, name):
    """Every parameter's gradient of the first step, on every rank, is the
    JAX 1F1B schedule's: the embed's and the head's counted once over
    ``pipe`` (a head gradient counted S times would be twice these)."""
    for got in _results(runs, name):
        _close_grads(got["grads"], runs["jax"][name]["grads"])


# -- 3. GPipe, 1F1B, the split layout and one process agree --------------------------------


@pytest.mark.parametrize("name,one", [
    ("1f1b_m2", "unpacked"), ("gpipe_m2", "unpacked"), ("gpipe_split", "unpacked"),
    ("1f1b_split", "unpacked"), ("1f1b_packed", "packed"), ("gpipe_packed", "packed")])
def test_schedules_and_layouts_equal_one_process(runs, name, one):
    """GPipe and 1F1B, standard and split layout: the one-process step's
    losses, norms, gradients, per-layer norms and histograms, and its
    parameters after the steps (the split layout gathered to the standard
    state dict)."""
    _, batch, tc_kw, _, steps = STEPS[name]
    hist, grads, state, telemetry = _one_process(runs["sd"], runs["batches"][one], tc_kw,
                                                 steps)
    for got in _results(runs, name):
        np.testing.assert_allclose(np.asarray(got["hist"])[:, 0], hist[:, 0], rtol=1e-5)
        np.testing.assert_allclose(np.asarray(got["hist"])[:, 1], hist[:, 1], rtol=1e-4)
        _close_grads({k: v for k, v in got["grads"].items() if k in grads}, grads)
        np.testing.assert_allclose(got["telemetry"]["grad_norms/stacked"].numpy(),
                                   telemetry["grad_norms/stacked"].numpy(), rtol=1e-4)
        assert torch.equal(got["telemetry"]["hist/grads/counts"].sum(1),
                           telemetry["hist/grads/counts"].sum(1))
        _close_params(got["params"], state.model.state_dict(), steps)


def test_gpipe_equals_1f1b(runs):
    """The two schedules on the same state give the same losses and the
    same gradients (the dry run's fifth program, at dropout 0)."""
    for a, b in zip(_results(runs, "gpipe_m2"), _results(runs, "1f1b_m2")):
        np.testing.assert_allclose(np.asarray(a["hist"])[:, 0], np.asarray(b["hist"])[:, 0],
                                   rtol=1e-5)
        _close_grads(a["grads"], {k: v.numpy() for k, v in b["grads"].items()})


@pytest.mark.parametrize("name", list(NCCL_HOPS))
def test_nccl_hops_issue_no_empty_batch(runs, name):
    """Under NCCL a hop is one ``batch_isend_irecv``, which raises on an empty
    list: a rank with no part in a hop (GPipe's fill and drain ticks, stage
    0's first gradient hop in 1F1B, the middle stages of pipe = 4) issues
    none. The step equals the gloo branch's bit for bit."""
    for got, want in zip(_results(runs, name), _results(runs, NCCL_HOPS[name])):
        assert got["batches"] and min(got["batches"]) > 0, got["batches"]
        assert got["hist"][0] == want["hist"][0]
        for k, g in want["grads"].items():
            assert torch.equal(got["grads"][k], g), k


# -- 4. the layouts and the restrictions ------------------------------------------------------


def test_merge_of_split_is_the_identity(runs):
    """merge(split(x)) == x, and the split stacks the layers in order
    (tests/test_pipeline.py:134)."""
    sd = runs["sd"]
    split = split_pipeline_params(sd, CFG.self_num_layers)
    assert all(not k.startswith("multimodal_encoder.layers.") for k in split["rest"])
    w = split["layers"]["self_attn.in_proj_weight"]
    assert w.shape[0] == CFG.self_num_layers
    assert torch.equal(w[3], sd["multimodal_encoder.layers.3.self_attn.in_proj_weight"])
    merged = merge_pipeline_params(split, CFG.self_num_layers)
    assert merged.keys() == sd.keys() and all(torch.equal(merged[k], v) for k, v in sd.items())


def test_split_layout_exports_the_standard_state_dict(runs):
    """Each stage of the split layout held its own layers only; the state
    gathered from them is the standard one, loadable in one process, equal
    to the standard layout's run (tests/test_pipeline.py:229)."""
    for got, want in zip(_results(runs, "gpipe_split"), _results(runs, "gpipe_m2")):
        model = build_model(CFG, "cpu")
        model.load_state_dict(got["params"], strict=True)
        _close_params(got["params"], want["params"], STEPS["gpipe_m2"][4])


def _mesh(**axes) -> Mesh:
    sizes = dict(data=1, model=1, seq=1, pipe=1) | axes
    return Mesh(sizes=sizes, coords=dict.fromkeys(sizes, 0), rank=0,
                world=int(np.prod(list(sizes.values()))), device=torch.device("cpu"),
                backend="gloo")


@pytest.mark.parametrize("cfg_kw,axes,m,batch,match", [
    ({}, dict(data=2, pipe=4), 3, 8, "not divisible by data axis"),
    ({"self_num_layers": 6}, dict(data=2, pipe=4), 2, 8, "layers not divisible"),
    ({"attention_impl": "ring"}, dict(data=2, pipe=4), 2, 8, "ring"),
    ({}, dict(data=2, seq=2, pipe=2), 2, 8, "seq=1"),
    ({"attention_impl": "pallas"}, dict(data=2, model=2, pipe=2), 2, 8, "attention_impl"),
    ({"fusion": "cross"}, dict(pipe=2), 2, 8, "concat-fusion"),
    ({}, dict(pipe=2), 0, 8, "n_microbatches"),
])
def test_validate_pipeline_errors(cfg_kw, axes, m, batch, match):
    """Each restriction raises the JAX rule's ValueError (tests/test_pipeline.py:145)."""
    from repurpose_tpu.parallel.pipeline import validate_pipeline as jax_validate

    cfg = dataclasses.replace(CFG, **cfg_kw)
    with pytest.raises(ValueError, match=match):
        validate_pipeline(cfg, _mesh(**axes), m, batch)
    jcfg = dataclasses.replace(JCFG, **cfg_kw)
    jmesh = jax_create_mesh(JMeshConfig(**(dict(data=1, model=1, seq=1, pipe=1) | axes)))
    with pytest.raises(ValueError, match=match):
        jax_validate(jcfg, jmesh, m, batch)


def test_pipe_x_tp_with_xla_attention_validates():
    assert validate_pipeline(dataclasses.replace(CFG, attention_impl="xla"),
                             _mesh(data=2, model=2, pipe=2), 2, 8) == (2, 2)


def test_gradient_accumulation_raises_under_pipe():
    with pytest.raises(ValueError, match="pipeline_microbatches"):
        make_train_step(CFG, TrainConfig(grad_accum_steps=2), None, _mesh(pipe=2))


# -- 5. the Trainer on a pipe = 2 mesh --------------------------------------------------------


def test_trainer_1f1b_matches_the_jax_trainer(runs):
    """A packed epoch through the Trainer's default 1F1B schedule on pipe = 2
    against the JAX Trainer's on the same mesh (tests/test_pipeline_1f1b.py:290)."""
    want = runs["jax"]["trainer"]
    for got in _results(runs, "trainer_1f1b"):
        assert got["step"] == want["step"] > 0
        np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-3)


def test_trainer_schedules_agree_and_write_the_standard_checkpoint(runs):
    """GPipe and 1F1B Trainers (tests/test_pipeline.py:202) train alike, their
    val probe rides the GPipe forward, ``evaluate`` runs on every rank, and
    the checkpoint is the one-process state dict."""
    f1b, gp = _results(runs, "trainer_1f1b"), _results(runs, "trainer_gpipe")
    for a, b in zip(f1b, gp):
        np.testing.assert_allclose(a["final_loss"], b["final_loss"], rtol=1e-5)
        np.testing.assert_allclose(a["val"], b["val"], rtol=1e-5)
        assert a["eval"] == pytest.approx(b["eval"], abs=1e-6)
    assert f1b[0]["val"] == f1b[1]["val"] and f1b[0]["eval"] == f1b[1]["eval"]
    model = build_model(TRAINER_MODEL, "cpu")
    model.load_state_dict(f1b[0]["ckpt"], strict=True)
    assert f1b[0]["ckpt"].keys() == runs["trainer_sd"].keys()
