"""The port's data and tensor parallelism (``repurpose_tpu_torch/parallel``)
on the CPU, against the JAX package's mesh.

Workers are subprocesses that import only torch and the port; each launch
starts one world over gloo (a ``file://`` store under ``tmp_path``, so no
port is shared between test workers) and runs every case of that world
size, re-grouping the same processes into one mesh after another. This
process computes the references: the JAX step on the 8-device virtual CPU
mesh of ``tests/conftest.py`` with the same ``MeshConfig``, batch and
weights (``state_dict_from_jax_params``), and the port's one-process runs.

Tolerances: against JAX, the JAX test's own (``tests/test_sharding.py``:
loss rtol 2e-3, grad norm rtol 1e-2, over 5 steps); port mesh against port
one process, float32 sums in another order: loss rtol 1e-5 over a few
Adam steps; ZeRO-1 against the replicated optimizer and shard-then-gather:
bit for bit (elementwise updates, copies).
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repurpose_tpu.config import MeshConfig as JMeshConfig
from repurpose_tpu.config import ModelConfig as JModelConfig
from repurpose_tpu.config import TrainConfig as JTrainConfig
from repurpose_tpu.data.batching import collate as jax_collate
from repurpose_tpu.data.batching import pack_batch as jax_pack_batch
from repurpose_tpu.data.batching import plan_packing as jax_plan_packing
from repurpose_tpu.data.loader import BatchLoader as JBatchLoader
from repurpose_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from repurpose_tpu.parallel.mesh import create_mesh as jax_create_mesh
from repurpose_tpu.parallel.sharding import make_global_batch, shard_params
from repurpose_tpu.train.state import create_train_state
from repurpose_tpu.train.step import make_train_step as jax_make_train_step
from repurpose_tpu_torch.config import Config, MeshConfig, ModelConfig, TestConfig, TrainConfig
from repurpose_tpu_torch.data.batching import Batch
from repurpose_tpu_torch.data.loader import BatchLoader
from repurpose_tpu_torch.data.synthetic import SyntheticDataset
from repurpose_tpu_torch.models import build_model, state_dict_from_jax_params
from repurpose_tpu_torch.parallel import mesh as pmesh
from repurpose_tpu_torch.parallel.dryrun import dryrun_multichip
from repurpose_tpu_torch.parallel.sharding import (
    param_sharding_rule,
    place_shard,
    shard_state_dict,
    shard_tensor,
)
from repurpose_tpu_torch.train.checkpoint import Checkpointer
from repurpose_tpu_torch.train.loop import Trainer
from repurpose_tpu_torch.train.state import TrainState, make_optimizer
from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

ROOT = Path(__file__).resolve().parent.parent

# tests/test_sharding.py's TINY at dropout 0; the port on its kernel route
# (the kernels' plain versions on CPU tensors), float32 interior
JTINY = JModelConfig(vis_dim=8, aud_dim=12, text_dim=4, d_model=16, self_num_layers=1,
                     num_heads=2, d_ff=32, hidden_dim=8, compute_dtype="float32",
                     attention_impl="xla", matmul_precision="highest", dropout=0.0)
TINY = ModelConfig(vis_dim=8, aud_dim=12, text_dim=4, d_model=16, self_num_layers=1,
                   num_heads=2, d_ff=32, hidden_dim=8, compute_dtype="float32",
                   attention_impl="auto", attn_softmax_dtype="float32", dropout=0.0)
GLOBAL = 8  # rows of the global batch
STEPS = 5
# parameters after a few Adam steps, mesh against one process: Adam scales
# every update to about lr = 1e-3, so on gradients that are float32 noise
# (the key bias's, which softmax cancels) a different summation order moves
# the parameter by up to lr a step; tests/test_zero1.py bounds it so (5e-4)
PARAM_ATOL = 5e-4
# the Trainer cases: two layers, four heads (two a model rank)
TRAINER_MODEL = dataclasses.replace(TINY, self_num_layers=2, num_heads=4, d_ff=64)
TRAIN_DURS = [100, 90, 50, 95, 40, 30, 60, 45, 70, 85, 55, 35]
TEST_DURS = [120, 60, 35, 80, 100, 45, 70]
TEST_CFG = TestConfig(pre_nms_topk=64, pre_nms_thresh=0.2, duration_thresh=0.001,
                      duration_thresh_max=90.0, max_seg_per_min=1.0)

MESHES = {"data2": dict(data=2), "model2": dict(data=1, model=2),
          "data2_model2": dict(data=2, model=2)}
WORLD = {"data2": 2, "model2": 2, "data2_model2": 4}
JAX_CASES = [(m, kind) for m in MESHES for kind in ("unpacked", "packed")]
STEP_CASES = JAX_CASES + [("data2", "uneven"), ("data2_model2", "uneven")]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches() -> dict:
    """The global batches as numpy: tests/test_sharding.py's unpacked and
    packed ones."""
    ds = JSyntheticDataset([50, 40, 60, 55, 45, 58, 52, 48], JTINY, seed=4)
    unpacked = jax_collate([ds[i] for i in range(GLOBAL)], (64,), GLOBAL)
    durs = [30, 20, 28, 25, 30, 22, 26, 24]
    pds = JSyntheticDataset(durs, JTINY, seed=4)
    packed = jax_pack_batch([pds[i] for i in range(len(durs))],
                            jax_plan_packing(durs, 64, GLOBAL)[0], bucket=64,
                            batch_size=GLOBAL)
    # a packed batch whose rows hold 2, 3 and 4 videos: the data ranks'
    # real-video counts differ, so a mean of per-rank losses is not the loss
    udurs = [40, 20, 30, 25, 8, 15, 12, 10, 9]
    uds = JSyntheticDataset(udurs, JTINY, seed=5)
    uneven = jax_pack_batch([uds[i] for i in range(len(udurs))],
                            jax_plan_packing(uds.lengths(), 64, GLOBAL)[0], bucket=64,
                            batch_size=GLOBAL)
    return {"unpacked": unpacked, "packed": packed, "uneven": uneven}


def _train_cfg(packed: bool, data: int = 1, **kw) -> dict:
    """TrainConfig kwargs; ``batch_size`` per rank (the global 8 over data)."""
    return dict(batch_size=GLOBAL // data, buckets=(64,), epochs=1, lr=1e-3,
                loss_norm="batch_size" if packed else "config_batch_size",
                pack_sequences=packed, **kw)


def _trainer_cfg(mesh: dict, batch_size: int) -> Config:
    return Config(
        model=TRAINER_MODEL,
        train=TrainConfig(batch_size=batch_size, buckets=(64, 128), epochs=1, save_epochs=1,
                          eval_freq=0, intra_epoch_eval_freq=0, lr=1e-3,
                          pack_sequences=True, loss_norm="batch_size"),
        mesh=MeshConfig(**mesh), test_cfg=TEST_CFG)


WORKER = r'''
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{root}/store{world}", rank=rank,
                        world_size=world)
from repurpose_tpu_torch.config import Config, MeshConfig, ModelConfig, TestConfig, TrainConfig
from repurpose_tpu_torch.data.batching import Batch
from repurpose_tpu_torch.data.synthetic import SyntheticDataset
from repurpose_tpu_torch.models import build_model
from repurpose_tpu_torch.parallel.mesh import create_mesh, mesh_self_check
from repurpose_tpu_torch.parallel.sharding import gather_state_dict, local_rows, shard_state_dict
from repurpose_tpu_torch.train.checkpoint import Checkpointer
from repurpose_tpu_torch.train.loop import Trainer
from repurpose_tpu_torch.train.state import TrainState, make_optimizer, optimizer_state_bytes
from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

spec = json.load(open(f"{root}/spec.json"))
MODEL = ModelConfig(**spec["model"])
SD = torch.load(f"{root}/init.pt", weights_only=True)
BATCHES = {}
for name in ("unpacked", "packed", "uneven"):
    z = np.load(f"{root}/{name}.npz")
    BATCHES[name] = Batch(*[z[f] if f in z.files else None for f in Batch._fields])


def mesh_of(axes):
    mesh = create_mesh(MeshConfig(**axes), "gloo", "cpu")
    assert mesh_self_check(mesh) == world
    return mesh


def run_steps(axes, batch, tc_kw, steps, model_kw=None):
    mesh = mesh_of(axes)
    mc = dataclasses.replace(MODEL, **(model_kw or {}))
    tc = TrainConfig(**tc_kw)
    model = build_model(mc, "cpu", mesh=mesh)
    model.load_state_dict(shard_state_dict(SD, mesh))
    model.set_dropout_generator(torch.Generator().manual_seed(tc.seed))
    opt, schedule = make_optimizer(model, tc, 2, mesh)
    state = TrainState(model, opt, mesh=mesh)
    step = make_train_step(mc, tc, schedule, mesh)
    dev = batch_to_device(local_rows(BATCHES[batch], mesh), "cpu")
    hist = []
    for _ in range(steps):
        m = step(state, dev)
        hist.append([float(m["loss"]), float(m["grad_norm"])])
    return state, mesh, step, dev, hist


out = {}
for case in spec["cases"][str(world)]:
    kind = case["kind"]
    if kind == "steps":
        state, mesh, *_ , hist = run_steps(case["mesh"], case["batch"], case["train"],
                                          case["steps"], case.get("model"))
        out[case["name"]] = {"hist": hist, "opt_bytes": optimizer_state_bytes(state.optimizer),
                             "params": state.gathered()[0] if case.get("params") else None}
    elif kind == "telemetry":
        from repurpose_tpu_torch.train.step import param_histograms

        state, mesh, step, dev, _ = run_steps(case["mesh"], case["batch"], case["train"], 0)
        ph = param_histograms(state.model, mesh)
        m = step(state, dev, per_layer_grad_norms=True, grad_histograms=True)
        out[case["name"]] = {k: m[k] for k in ("grad_norms/stacked", "hist/grads/counts",
                                               "hist/grads/edges")}
        out[case["name"]].update({"params/" + k: v for k, v in ph.items()})
    elif kind == "gather":
        mesh = mesh_of(case["mesh"])
        model = build_model(MODEL, "cpu", mesh=mesh)
        model.load_state_dict(shard_state_dict(SD, mesh))
        got = gather_state_dict(model.state_dict(), mesh)
        out[case["name"]] = {"equal": all(torch.equal(got[k], SD[k]) for k in SD),
                             "local": {k: tuple(v.shape) for k, v in model.state_dict().items()}}
    elif kind == "checkpoint":
        tc_kw = case["train"]
        # (1) restore the one-process checkpoint A, then continue
        state, mesh, step, dev, _ = run_steps(case["mesh"], case["batch"], tc_kw, 0)
        ckpt = Checkpointer(f"{root}/ckA")
        state, _ = ckpt.restore(state)
        assert state.step == 2, state.step
        after_a = [float(step(state, dev)["loss"]) for _ in range(2)]
        # (2) two steps here, save B (rank 0 writes the gathered state), continue
        state, mesh, step, dev, _ = run_steps(case["mesh"], case["batch"], tc_kw, 2)
        Checkpointer(f"{root}/ckB").save(state.step, state, {"epoch": 0})
        after_b = [float(step(state, dev)["loss"]) for _ in range(2)]
        # (3) B restored on this mesh: the same continuation, bit for bit
        state, mesh, step, dev, _ = run_steps(case["mesh"], case["batch"], tc_kw, 0)
        state, _ = Checkpointer(f"{root}/ckB").restore(state)
        resumed = [float(step(state, dev)["loss"]) for _ in range(2)]
        out[case["name"]] = {"after_a": after_a, "after_b": after_b, "resumed": resumed}
    elif kind == "trainer":
        cfg = Config(model=ModelConfig(**case["model"]), train=TrainConfig(**case["train"]),
                     mesh=MeshConfig(**case["mesh"]), test_cfg=TestConfig(**case["test"]))
        train_ds = SyntheticDataset(case["train_durs"], cfg.model, seed=1)
        test_ds = SyntheticDataset(case["test_durs"], cfg.model, seed=3)
        init = torch.load(f"{root}/trainer_init.pt", weights_only=True)
        trainer = Trainer(cfg, f"{root}/{case['name']}", train_ds, test_ds=test_ds,
                          init_params=init, device="cpu")
        res = {"eval": trainer.evaluate(pack=False), "eval_packed": trainer.evaluate(pack=True)}
        if case.get("fit"):
            summary = trainer.fit()
            res.update(final_loss=summary["final_loss"], step=summary["step"])
        trainer.close()
        out[case["name"]] = res
    dist.barrier()

torch.save(out, f"{root}/out{world}_rank{rank}.pt")
dist.destroy_process_group()
'''


def _communicate_all(procs, timeout=300):
    """communicate() on every worker, killing all of them on any failure (as
    tests/test_multihost.py does)."""
    try:
        return [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def _jax_trajectory(mesh_axes: dict, batch, packed: bool, params) -> np.ndarray:
    """[STEPS, 2] (loss, grad norm) of the JAX step on the JAX mesh."""
    jtc = JTrainConfig(**_train_cfg(packed))
    state, tx, sched = create_train_state(JTINY, jtc, 2, jax.random.key(0))
    state = dataclasses.replace(state, params=params)
    step = jax_make_train_step(JTINY, jtc, tx, sched, donate=False)
    mesh = jax_create_mesh(JMeshConfig(**mesh_axes))
    state = dataclasses.replace(state, params=shard_params(state.params, mesh))
    dev_batch = make_global_batch(batch, mesh)
    out = []
    for _ in range(STEPS):
        state, m = step(state, dev_batch, jax.random.key(7))
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return np.asarray(out)


def _one_process_steps(sd, batch, tc_kw, steps, model=TINY, state=None):
    """The port's one-process run: (state, step, device batch, losses)."""
    tc = TrainConfig(**tc_kw)
    if state is None:
        m = build_model(model, "cpu")
        m.load_state_dict(sd)
        m.set_dropout_generator(torch.Generator().manual_seed(tc.seed))
        opt, _ = make_optimizer(m, tc, 2)
        state = TrainState(m, opt)
    _, schedule = make_optimizer(state.model, tc, 2)
    step = make_train_step(model, tc, schedule)
    dev = batch_to_device(Batch(*batch), "cpu")
    losses = [float(step(state, dev)["loss"]) for _ in range(steps)]
    return state, step, dev, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' results, and the references they are held to."""
    root = tmp_path_factory.mktemp("parallel")
    batches = _batches()
    jstate, _, _ = create_train_state(JTINY, JTrainConfig(**_train_cfg(False)), 2,
                                      jax.random.key(0))
    params = jax.device_get(jstate.params)
    sd = state_dict_from_jax_params(params)
    torch.save(sd, root / "init.pt")
    for name, b in batches.items():
        np.savez(root / f"{name}.npz", **{f: x for f, x in zip(b._fields, b) if x is not None})
    trainer_sd = build_model(TRAINER_MODEL, "cpu", seed=5).state_dict()
    # random weights give zero-length clips; offsets of ~15 s make tIoU > 0
    trainer_sd["reg_head.7.bias"] = torch.full_like(trainer_sd["reg_head.7.bias"], 15.0)
    torch.save(trainer_sd, root / "trainer_init.pt")

    # checkpoint A: two one-process steps (ZeRO-1 asked for, a no-op at data=1)
    ck_tc = _train_cfg(False, shard_opt_state=True)
    state, step, dev, _ = _one_process_steps(sd, batches["unpacked"], ck_tc, 2)
    Checkpointer(str(root / "ckA")).save(state.step, state, {"epoch": 0})
    after_a = [float(step(state, dev)["loss"]) for _ in range(2)]

    cases = {"2": [], "4": []}
    for mesh_name, kind in STEP_CASES:
        axes = MESHES[mesh_name]
        cases[str(WORLD[mesh_name])].append(dict(
            kind="steps", name=f"{mesh_name}_{kind}", mesh=axes, batch=kind,
            train=_train_cfg(kind != "unpacked", axes.get("data", 1)), steps=STEPS))
    for zero1 in (False, True):
        cases["2"].append(dict(kind="steps", name=f"zero1_{zero1}", mesh=MESHES["data2"],
                               batch="unpacked", steps=3, params=True,
                               train=_train_cfg(False, 2, shard_opt_state=zero1)))
    cases["4"].append(dict(kind="steps", name="zero1_data2_model2", mesh=MESHES["data2_model2"],
                           batch="packed", steps=3, params=True,
                           train=_train_cfg(True, 2, shard_opt_state=True)))
    cases["2"].append(dict(kind="steps", name="model2_dropout", mesh=MESHES["model2"],
                           batch="packed", steps=3, model={"dropout": 0.1},
                           train=_train_cfg(True)))
    cases["2"].append(dict(kind="gather", name="gather", mesh=MESHES["model2"]))
    cases["2"].append(dict(kind="steps", name="data2_accum", mesh=MESHES["data2"],
                           batch="uneven", steps=3,
                           train=_train_cfg(True, 2, grad_accum_steps=2)))
    cases["2"].append(dict(kind="telemetry", name="model2_telemetry", mesh=MESHES["model2"],
                           batch="packed", train=_train_cfg(True)))
    cases["4"].append(dict(kind="checkpoint", name="checkpoint", mesh=MESHES["data2_model2"],
                           batch="unpacked", train=_train_cfg(False, 2, shard_opt_state=True)))
    for mesh_name in ("data2", "model2"):
        data = MESHES[mesh_name].get("data", 1)
        cfg = _trainer_cfg(MESHES[mesh_name], 4 // data)
        cases["2"].append(dict(
            kind="trainer", name=f"trainer_{mesh_name}", mesh=MESHES[mesh_name],
            model=dataclasses.asdict(cfg.model), train=dataclasses.asdict(cfg.train),
            test=dataclasses.asdict(TEST_CFG), train_durs=TRAIN_DURS, test_durs=TEST_DURS,
            fit=True))
    (root / "spec.json").write_text(json.dumps(
        {"model": dataclasses.asdict(TINY), "cases": cases}))

    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(root)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=str(ROOT))
             for world in (2, 4) for r in range(world)]
    # the JAX references while the workers run, compiled three at a time
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {f"{m}_{kind}": pool.submit(_jax_trajectory, MESHES[m], batches[kind],
                                              kind != "unpacked", params)
                   for m, kind in JAX_CASES}
        jax_refs = {name: f.result() for name, f in futures.items()}
    logs = _communicate_all(procs)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    out = {w: [torch.load(root / f"out{w}_rank{r}.pt", weights_only=False) for r in range(w)]
           for w in (2, 4)}
    return dict(root=root, sd=sd, trainer_sd=trainer_sd, batches=batches, jax=jax_refs,
                out=out, after_a=after_a, ck_tc=ck_tc)


def _results(runs, name: str) -> list:
    """Every rank's result of case ``name``, from whichever world ran it."""
    world = next(w for w, outs in runs["out"].items() if name in outs[0])
    return [o[name] for o in runs["out"][world]]


# -- 1. the mesh steps against the JAX steps on the same mesh ----------------------


@pytest.mark.parametrize("mesh_name,kind", JAX_CASES)
def test_mesh_step_matches_the_jax_step_on_the_same_mesh(runs, mesh_name, kind):
    name = f"{mesh_name}_{kind}"
    want = runs["jax"][name]
    for rank, got in enumerate(_results(runs, name)):
        hist = np.asarray(got["hist"])
        np.testing.assert_allclose(hist[:, 0], want[:, 0], rtol=2e-3, err_msg=f"rank {rank}")
        np.testing.assert_allclose(hist[:, 1], want[:, 1], rtol=1e-2, err_msg=f"rank {rank}")


@pytest.mark.parametrize("mesh_name,kind", STEP_CASES)
def test_mesh_step_matches_the_one_process_step(runs, mesh_name, kind):
    """Every rank logs the global batch's loss and norm, the one-process
    step's on all 8 rows, to float32 summation order."""
    _, _, _, want = _one_process_steps(runs["sd"], runs["batches"][kind],
                                       _train_cfg(kind != "unpacked"), STEPS)
    for got in _results(runs, f"{mesh_name}_{kind}"):
        np.testing.assert_allclose(np.asarray(got["hist"])[:, 0], want, rtol=1e-5)


def test_uneven_ranks_need_the_global_denominator(runs):
    """On the uneven batch the two data ranks hold different numbers of
    videos: the mean of their own-denominator losses is not the global
    loss the data=2 step reports."""
    from repurpose_tpu_torch.train.step import loss_fn

    batch = Batch(*runs["batches"]["uneven"])
    tc = TrainConfig(**_train_cfg(True))
    model = build_model(TINY, "cpu")
    model.load_state_dict(runs["sd"])
    with torch.no_grad():
        (whole, aux), = [loss_fn(model, tc, batch_to_device(batch, "cpu"))]
        parts = [loss_fn(model, tc, batch_to_device(Batch(*[None if x is None else x[r::2]
                                                           for x in batch]), "cpu"))
                 for r in range(2)]
    counts = [int(a["n_real"]) for _, a in parts]
    assert counts[0] != counts[1] and sum(counts) == int(aux["n_real"])
    naive = float(sum(loss for loss, _ in parts)) / 2
    assert abs(naive - float(whole)) > 1e-2 * float(whole)
    for got in _results(runs, "data2_uneven"):
        assert got["hist"][0][0] == pytest.approx(float(whole), rel=1e-5)


def test_gradient_accumulation_reduces_once_per_step(runs):
    """data=2 with two accumulation chunks a rank, on the uneven batch: the
    global denominator divides every chunk and the summed gradients are
    reduced once, giving the one-process step without accumulation."""
    _, _, _, want = _one_process_steps(runs["sd"], runs["batches"]["uneven"],
                                       _train_cfg(True), 3)
    for got in _results(runs, "data2_accum"):
        np.testing.assert_allclose(np.asarray(got["hist"])[:, 0], want, rtol=1e-5)


def test_tensor_parallel_telemetry_is_of_the_whole_model(runs):
    """Per-matrix gradient norms (squared norms of shards summed over model)
    and the gradient and parameter histograms (of gathered values) equal the
    one-process step's."""
    from repurpose_tpu_torch.train.step import param_histograms

    tc = TrainConfig(**_train_cfg(True))
    model = build_model(TINY, "cpu")
    model.load_state_dict(runs["sd"])
    opt, schedule = make_optimizer(model, tc, 2)
    state = TrainState(model, opt)
    ph = param_histograms(model)
    m = make_train_step(TINY, tc, schedule)(
        state, batch_to_device(Batch(*runs["batches"]["packed"]), "cpu"),
        per_layer_grad_norms=True, grad_histograms=True)
    for got in _results(runs, "model2_telemetry"):
        assert torch.equal(got["params/counts"], ph["counts"])
        assert torch.equal(got["params/edges"], ph["edges"])
        np.testing.assert_allclose(got["grad_norms/stacked"].numpy(),
                                   m["grad_norms/stacked"].numpy(), rtol=1e-5)
        np.testing.assert_allclose(got["hist/grads/edges"].numpy(),
                                   m["hist/grads/edges"].numpy(), rtol=1e-5, atol=1e-6)
        # a value within float32 order of a bin edge may fall on its other side
        diff = (got["hist/grads/counts"] - m["hist/grads/counts"]).abs()
        assert diff.sum() <= 4 and torch.equal(got["hist/grads/counts"].sum(1),
                                                m["hist/grads/counts"].sum(1))


# -- 2. ZeRO-1 ------------------------------------------------------------------------


def test_zero1_equals_replicated_adam_bit_for_bit(runs):
    rep, z1 = _results(runs, "zero1_False"), _results(runs, "zero1_True")
    for r in range(2):
        assert rep[r]["hist"] == z1[r]["hist"]
        for k, v in rep[r]["params"].items():
            assert torch.equal(v, z1[r]["params"][k]), k


def test_zero1_halves_each_ranks_optimizer_state(runs):
    rep, z1 = _results(runs, "zero1_False"), _results(runs, "zero1_True")
    for r in range(2):
        # above half by the step counters (one 4-byte scalar a parameter on
        # each rank) and the cls head's out bias ([1]), kept whole on both
        assert rep[r]["opt_bytes"] / 2 < z1[r]["opt_bytes"]
        assert z1[r]["opt_bytes"] == pytest.approx(rep[r]["opt_bytes"] / 2, rel=0.01)


def test_zero1_composes_with_tensor_parallelism(runs):
    """data=2 x model=2 with ZeRO-1 equals the one-process run's parameters."""
    state, _, _, losses = _one_process_steps(runs["sd"], runs["batches"]["packed"],
                                             _train_cfg(True), 3)
    want = state.model.state_dict()
    for got in _results(runs, "zero1_data2_model2"):
        np.testing.assert_allclose(np.asarray(got["hist"])[:, 0], losses, rtol=1e-5)
        for k, v in got["params"].items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=PARAM_ATOL, err_msg=k)


# -- 3. checkpoints across mesh shapes ---------------------------------------------------


def test_checkpoint_from_one_process_resumes_on_data2_model2(runs):
    for got in _results(runs, "checkpoint"):
        np.testing.assert_allclose(got["after_a"], runs["after_a"], rtol=1e-5)


def test_zero1_checkpoint_resumes_step_exact_on_its_mesh(runs):
    """Saved at data=2 x model=2 with ZeRO-1 (gathered) and restored there
    (sharded again): the uninterrupted run's losses, bit for bit."""
    for got in _results(runs, "checkpoint"):
        assert got["resumed"] == got["after_b"]


def test_checkpoint_from_data2_model2_resumes_in_one_process(runs):
    """Rank 0 wrote the gathered state, reference-named: it loads strictly in
    one process, continues as the mesh did, and equals checkpoint A (the same
    two steps in one process) to float32 order."""
    root = runs["root"]
    tc = TrainConfig(**runs["ck_tc"])
    model = build_model(TINY, "cpu")
    opt, _ = make_optimizer(model, tc, 2)
    state, _ = Checkpointer(str(root / "ckB")).restore(TrainState(model, opt))
    assert state.step == 2
    _, _, _, losses = _one_process_steps(None, runs["batches"]["unpacked"], runs["ck_tc"], 2,
                                         state=state)
    for got in _results(runs, "checkpoint"):
        np.testing.assert_allclose(got["after_b"], losses, rtol=1e-5)
    a = torch.load(root / "ckA" / "2.pt", weights_only=True)
    b = torch.load(root / "ckB" / "2.pt", weights_only=True)
    for k, v in a["model"].items():
        np.testing.assert_allclose(b["model"][k].numpy(), v.numpy(), atol=PARAM_ATOL, err_msg=k)
    assert a["optimizer"]["state"].keys() == b["optimizer"]["state"].keys()
    for i, s in a["optimizer"]["state"].items():
        for m in ("exp_avg", "exp_avg_sq"):
            # relative to the tensor's largest moment: the key bias's are noise
            want = s[m].numpy()
            np.testing.assert_allclose(b["optimizer"]["state"][i][m].numpy(), want,
                                       rtol=1e-4, atol=1e-4 * np.abs(want).max())


# -- 4. the loader's per-rank slices -----------------------------------------------------


@pytest.mark.parametrize("pack", [False, True])
def test_loader_rank_slices_equal_the_jax_loaders(pack):
    durs = [100, 90, 50, 95, 40, 30, 60, 45, 70, 85, 55]
    jds = JSyntheticDataset(durs, JTINY, seed=1)
    ds = SyntheticDataset(durs, TINY, seed=1)
    for rank in range(2):
        kw = dict(batch_size=2, buckets=(64, 128), shuffle=True, seed=3, pack=pack,
                  process_index=rank, process_count=2)
        ours, theirs = BatchLoader(ds, **kw), JBatchLoader(jds, **kw)
        for epoch in range(2):
            got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for f, x in zip(Batch._fields, w):
                    if x is None:
                        assert getattr(g, f) is None, f
                    else:
                        np.testing.assert_array_equal(getattr(g, f), x, err_msg=f)


def test_loader_ranks_partition_every_global_batch():
    durs = [100, 90, 50, 95, 40, 30, 60, 45, 70, 85, 55]
    ds = SyntheticDataset(durs, TINY, seed=1)
    one = BatchLoader(ds, batch_size=4, buckets=(64, 128), seed=3)
    ranks = [BatchLoader(ds, batch_size=2, buckets=(64, 128), seed=3, process_index=r,
                         process_count=2) for r in range(2)]
    plan = one._epoch_batches(0)
    assert [b for b in plan if len(b[1]) >= 2] == ranks[0]._epoch_batches(0)
    for (bucket, idxs), *parts in zip(ranks[0]._epoch_batches(0),
                                      *[list(r.epoch(0)) for r in ranks]):
        got = sorted(int(d) for p in parts for d in p.durations if d > 0)
        assert got == sorted(min(ds.lengths()[i], bucket) for i in idxs)


def test_loader_refuses_ragged_tails_across_ranks():
    ds = SyntheticDataset([50, 40, 30], TINY, seed=1)
    for loader in (BatchLoader, JBatchLoader):
        with pytest.raises(ValueError, match="pad_last=False"):
            loader(ds, batch_size=2, buckets=(64,), pad_last=False, process_count=2)
    BatchLoader(ds, batch_size=2, buckets=(64,), pad_last=False, drop_last=True,
                process_count=2)


# -- 5. evaluation and the Trainer on a mesh ----------------------------------------------


@pytest.fixture(scope="module")
def one_process_trainer(runs, tmp_path_factory):
    cfg = _trainer_cfg(dict(data=1), 4)
    trainer = Trainer(cfg, str(tmp_path_factory.mktemp("one")),
                      SyntheticDataset(TRAIN_DURS, cfg.model, seed=1),
                      test_ds=SyntheticDataset(TEST_DURS, cfg.model, seed=3),
                      init_params=runs["trainer_sd"], device="cpu")
    res = {"eval": trainer.evaluate(pack=False), "eval_packed": trainer.evaluate(pack=True)}
    summary = trainer.fit()
    res.update(final_loss=summary["final_loss"], step=summary["step"],
               ckpt=trainer.checkpointer.restore_model())
    trainer.close()
    return res


@pytest.mark.parametrize("key", ["eval", "eval_packed"])
@pytest.mark.parametrize("mesh_name", ["data2", "model2"])
def test_multi_process_evaluate_equals_one_process(runs, one_process_trainer, mesh_name, key):
    want = one_process_trainer[key]
    assert any(v > 0 for v in want.values())
    for got in _results(runs, f"trainer_{mesh_name}"):
        assert got[key].keys() == want.keys()
        for k, v in want.items():
            assert got[key][k] == pytest.approx(v, abs=1e-6), k


@pytest.mark.parametrize("mesh_name", ["data2", "model2"])
def test_trainer_on_a_mesh_trains_like_one_process(runs, one_process_trainer, mesh_name):
    """A packed epoch through the Trainer: each rank its rows (data) or its
    heads (model) of the one-process Trainer's global batches, the epoch's
    mean loss the one-process one; rank 0 wrote the checkpoint, in the
    one-process form, with the one-process weights."""
    want = one_process_trainer
    for got in _results(runs, f"trainer_{mesh_name}"):
        assert got["step"] == want["step"] > 1
        assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-5)
    ck = Checkpointer(str(runs["root"] / f"trainer_{mesh_name}" / "ckpt"))
    assert ck.latest_step() == want["step"]
    got = ck.restore_model()
    model = build_model(TRAINER_MODEL, "cpu")
    model.load_state_dict(got, strict=True)
    for k, v in want["ckpt"].items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=PARAM_ATOL, err_msg=k)


# -- 6. tensor parallelism draws the one-process dropout masks ------------------------------


def test_tensor_parallel_dropout_equals_one_process(runs):
    model = dataclasses.replace(TINY, dropout=0.1)
    _, _, _, want = _one_process_steps(runs["sd"], runs["batches"]["packed"],
                                       _train_cfg(True), 3, model=model)
    _, _, _, undropped = _one_process_steps(runs["sd"], runs["batches"]["packed"],
                                            _train_cfg(True), 3)
    assert not np.allclose(want, undropped, rtol=1e-3)  # the masks matter
    for got in _results(runs, "model2_dropout"):
        np.testing.assert_allclose(np.asarray(got["hist"])[:, 0], want, rtol=1e-5)


# -- 7. the per-head split of the stacked q/k/v projection ------------------------------------


def test_shard_then_gather_is_the_identity(runs):
    sd = runs["sd"]
    for k, v in sd.items():
        shards = [shard_tensor(k, v, r, 2) for r in range(2)]
        if param_sharding_rule(k) is None:
            assert all(x is v for x in shards) and place_shard(k, v, 1, 2) is v
        else:
            assert torch.equal(sum(place_shard(k, x, r, 2) for r, x in enumerate(shards)), v)
    for got in _results(runs, "gather"):
        assert got["equal"]
        assert got["local"]["multimodal_encoder.layers.0.self_attn.in_proj_weight"] == (24, 16)
        assert got["local"]["multimodal_encoder.layers.0.linear2.weight"] == (16, 16)


def test_in_proj_shard_holds_the_ranks_heads_of_the_jax_projection(runs):
    """Rank r's q, k and v from its in_proj shard are heads [r H/M, (r+1) H/M)
    of the JAX qkv Dense's q, k, v, the heads the JAX rule leaves on model
    rank r; a contiguous third of the rows (the naive split) is not."""
    cfg = dataclasses.replace(JTINY, d_model=32, num_heads=4)
    params, _, _ = create_train_state(cfg, JTrainConfig(**_train_cfg(False)), 1,
                                      jax.random.key(2))
    qkv = jax.device_get(params.params["encoder"]["layer_0"]["attn"]["qkv"])
    sd = state_dict_from_jax_params(jax.device_get(params.params))
    name = "multimodal_encoder.layers.0.self_attn.in_proj_"
    x = np.random.default_rng(0).normal(size=(2, 5, 32)).astype(np.float32)
    d, h, size = 32, 4, 2
    jq = np.asarray(jnp.asarray(x) @ qkv["kernel"] + qkv["bias"]).reshape(2, 5, 3, h, d // h)
    for r in range(size):
        w = shard_tensor(name + "weight", sd[name + "weight"], r, size)
        b = shard_tensor(name + "bias", sd[name + "bias"], r, size)
        local = torch.nn.functional.linear(torch.from_numpy(x), w, b).numpy()
        local = local.reshape(2, 5, 3, h // size, d // h)
        np.testing.assert_allclose(local, jq[:, :, :, r * h // size : (r + 1) * h // size],
                                   rtol=1e-5, atol=1e-5)
        naive = sd[name + "weight"][r * 3 * d // size : (r + 1) * 3 * d // size]
        assert not torch.equal(naive, w)
    assert param_sharding_rule(name + "weight") == "heads"
    assert param_sharding_rule("multimodal_encoder.layers.3.self_attn.out_proj.bias") is None
    assert param_sharding_rule("cls_head.1.weight") is None


def test_shard_state_dict_matches_the_tensor_parallel_model():
    class Half:  # the model axis of a mesh: rank 1 of 2
        def size(self, axis):
            return 2 if axis == "model" else 1

        def coord(self, axis):
            return 1 if axis == "model" else 0

        def group(self, axis):
            return None

    full = build_model(TINY, "cpu").state_dict()
    shard = shard_state_dict(full, Half())
    from repurpose_tpu_torch.models.mmct import MMCT

    local = MMCT(TINY, Half()).state_dict()
    assert {k: tuple(v.shape) for k, v in shard.items()} == {
        k: tuple(v.shape) for k, v in local.items()}


# -- 8. the dry run, the mesh and its rules ---------------------------------------------------


def test_dryrun_multichip_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(4)


def test_dryrun_multichip_4():
    msg = dryrun_multichip(4, device="cpu")
    assert "mesh {'data': 2, 'model': 2, 'seq': 1, 'pipe': 1}" in msg, msg


@pytest.mark.parametrize("axes,n", [
    (dict(data=-1, model=2), 8), (dict(data=2, model=2, seq=2), 8), (dict(data=-1, pipe=4), 8),
    (dict(data=2), 2), (dict(data=3), 8), (dict(data=-1, model=-1), 4)])
def test_axis_sizes_match_the_jax_mesh_config(axes, n):
    try:
        want = JMeshConfig(**axes).axis_sizes(n)
    except ValueError:
        with pytest.raises(ValueError):
            MeshConfig(**axes).axis_sizes(n)
        return
    assert MeshConfig(**axes).axis_sizes(n) == want


def test_one_process_mesh_is_trivial():
    mesh = pmesh.create_mesh(MeshConfig(), device="cpu")
    assert mesh.world == 1 and mesh.backend is None and mesh.groups == {}
    assert mesh.sizes == {"data": 1, "model": 1, "seq": 1, "pipe": 1}
    assert pmesh.mesh_self_check(mesh) == 1
    assert "rank 0/1" in pmesh.describe_mesh(mesh)
    with pytest.raises(ValueError, match="does not cover"):
        pmesh.create_mesh(MeshConfig(data=1, model=2), device="cpu")


def test_rank_devices_refuse_more_ranks_than_cards_without_share_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="share_card"):
        pmesh.rank_device("cuda", 1, 2, "nccl", share_card=False)
    with pytest.raises(ValueError, match="gloo"):
        pmesh.rank_device("cuda", 1, 2, "nccl", share_card=True)
    assert pmesh.rank_device("cuda", 1, 2, "gloo", share_card=True) == torch.device("cuda", 0)
    assert pmesh.rank_device("cuda", 0, 1, "nccl", share_card=False) == torch.device("cuda", 0)
    assert pmesh.default_backend("cuda") == "nccl" and pmesh.default_backend("cpu") == "gloo"


def test_launcher_variables(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "SLURM_PROCID",
              "SLURM_NTASKS", "SLURM_LOCALID", "SLURM_NTASKS_PER_NODE"):
        monkeypatch.delenv(k, raising=False)
    assert pmesh._launcher_ranks() is None
    assert not pmesh.maybe_initialize_distributed(device="cpu")
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_LOCALID", "1")
    monkeypatch.setenv("SLURM_NTASKS_PER_NODE", "4(x2)")
    assert pmesh._launcher_ranks() == (3, 8, 1, 4)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pmesh._launcher_ranks() == (1, 2, 1, 2)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert pmesh._launcher_ranks() is None
