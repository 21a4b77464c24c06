"""Multi-process dry run (the counterpart of ``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n, device)`` starts ``n`` ranks as subprocesses
(``python -m repurpose_tpu_torch.parallel.dryrun --rank r ...``, the process
group over a file store) and carves the world as the JAX dry run does:
``model`` = 2 where ``n`` is even, ``seq`` = 2 with ring attention where
``n`` >= 8 and ``n % 4 == 0``, and ``data`` the rest. Each rank runs, on a
tiny model of the flagship's shape (8 heads):

1. the mesh self-check;
2. one dp × tp (× sp) train step with ZeRO-1 on its rows (and, under the
   ring, its columns) of an unpacked batch, and one dp × tp step on a
   packed batch (packing composes with tp, not with the ring: ``seq`` = 1);
3. the scoring forward and decode of its rows through ``InferencePipeline``
   on the mesh (the ring live where ``seq`` = 2);
4. where ``n`` is even, on a mesh of ``pipe`` = 2 and ``data`` the rest
   (``attention_impl="xla"``, 2 microbatches): the GPipe step on the split
   layout (each stage holding its own layer), the 1F1B step on the same
   split state, whose loss at dropout 0 must equal GPipe's, and, where
   ``n`` >= 4, the 1F1B step with ZeRO-1 on the standard layout;
5. where ``n`` is a multiple of 8, the 1F1B step of a 4-layer model on
   ``data`` = 2 × ``pipe`` = 4.

The parent holds every rank's losses equal and finite and equal to one
process's step on the global batch, and returns a summary line. It runs on
the card unless ``device`` is "cpu" (gloo ranks). On CUDA, ``share_card``
puts several ranks on one card over gloo; otherwise a rank needs a card of
its own (NCCL).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from repurpose_tpu_torch import resolve_device
from repurpose_tpu_torch.config import MeshConfig, ModelConfig, TestConfig, TrainConfig

MODEL = ModelConfig(vis_dim=32, aud_dim=64, text_dim=16, d_model=64, self_num_layers=2,
                    num_heads=8, d_ff=128, hidden_dim=32, dropout=0.0,
                    compute_dtype="float32", attn_softmax_dtype="float32")
BUCKET = 64
ROWS_PER_RANK = 2


def carve(n: int) -> MeshConfig:
    """The JAX dry run's axes for ``n`` ranks."""
    model = 2 if n % 2 == 0 else 1
    seq = 2 if n % (model * 2) == 0 and n >= 8 else 1
    return MeshConfig(data=-1, model=model, seq=seq, pipe=1)


def _pipe_programs(n: int) -> dict:
    """name -> (mesh axes, layers, schedule, split layout, ZeRO-1) of the
    pipeline programs that ``n`` ranks run."""
    out = {}
    if n % 2 == 0:
        out["gpipe_split"] = (dict(data=-1, pipe=2), 2, "gpipe", True, False)
        out["1f1b_split"] = (dict(data=-1, pipe=2), 2, "1f1b", True, False)
        if n >= 4:
            out["zero1_1f1b"] = (dict(data=-1, pipe=2), 2, "1f1b", False, True)
    if n % 8 == 0:
        out["data2_pipe4"] = (dict(data=2, pipe=4), 4, "1f1b", False, False)
    return out


def _batches(data: int):
    """(unpacked, packed) global batches of ``ROWS_PER_RANK * data`` rows."""
    from repurpose_tpu_torch.data.batching import collate, iter_packed_batches
    from repurpose_tpu_torch.data.synthetic import SyntheticDataset

    rows = ROWS_PER_RANK * data
    ds = SyntheticDataset([50 - 3 * i for i in range(rows)], MODEL, seed=0)
    unpacked = collate([ds[i] for i in range(rows)], (BUCKET,), rows)
    durs = [20 + (3 * i) % 11 for i in range(2 * rows)]
    pk_ds = SyntheticDataset(durs, MODEL, seed=2)
    (packed, _, _, _), = iter_packed_batches(lambda i: pk_ds[i], pk_ds.lengths(), (BUCKET,),
                                             rows)
    return unpacked, packed


def _step(mc, tc, mesh, batch, device, program=None) -> list[float]:
    """(loss, grad norm) of one step on ``batch``: this rank's part of it on
    ``mesh``, or all of it in one process (``mesh`` None); ``program`` a
    pipeline program's (schedule, split layout, ZeRO-1)."""
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.parallel.pipeline import create_pipeline_train_state
    from repurpose_tpu_torch.parallel.pipeline_1f1b import make_1f1b_train_step
    from repurpose_tpu_torch.parallel.sharding import local_rows, seq_split
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer
    from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

    schedule_name, split, zero1 = program or ("", False, False)
    if split:
        state, schedule = create_pipeline_train_state(mc, tc, mesh, 1, seed=0, device=device)
    else:
        model = build_model(mc, device, seed=0, mesh=mesh)
        opt, schedule = make_optimizer(model, tc, 1, mesh)
        state = TrainState(model, opt, mesh=mesh)
    if schedule_name == "1f1b":
        step = make_1f1b_train_step(mc, tc, schedule, mesh, tc.pipeline_microbatches,
                                    split_layout=split, zero1=zero1)
    else:
        step = make_train_step(mc, tc, schedule, mesh)
    if mesh is not None:
        batch = local_rows(batch, mesh, seq=seq_split(mc, mesh))
    m = step(state, batch_to_device(batch, device))
    return [float(m["loss"]), float(m["grad_norm"])]


def _configs(mesh_axes: dict, world: int) -> dict:
    """name -> (model config, train config (per-rank rows),
    global batch name, pipeline program) of every program but the scoring."""
    seq = mesh_axes["seq"] > 1
    unpacked_model = dataclasses.replace(MODEL, attention_impl="ring" if seq else "auto")
    out = {
        "unpacked": (unpacked_model, TrainConfig(
            batch_size=ROWS_PER_RANK, buckets=(BUCKET,), epochs=1, shard_opt_state=True,
            loss_norm="batch_size"), "unpacked", None),
        "packed": (MODEL, TrainConfig(
            batch_size=ROWS_PER_RANK, buckets=(BUCKET,), epochs=1, shard_opt_state=True,
            loss_norm="batch_size", pack_sequences=True), "packed", None),
    }
    for name, (axes, layers, sched, split, zero1) in _pipe_programs(world).items():
        mc = dataclasses.replace(MODEL, attention_impl="xla", self_num_layers=layers)
        out[name] = (mc, TrainConfig(
            batch_size=ROWS_PER_RANK, buckets=(BUCKET,), epochs=1, shard_opt_state=zero1,
            loss_norm="batch_size", pipeline_schedule=sched, pipeline_microbatches=2),
            "unpacked", (sched, split, zero1))
    return out


def _rank_main(args) -> None:
    import torch.distributed as dist

    from repurpose_tpu_torch.infer import InferencePipeline
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.parallel.mesh import create_mesh, mesh_self_check, rank_device
    from repurpose_tpu_torch.parallel.sharding import local_rows

    torch.set_num_threads(1)
    dev = rank_device(args.device, args.rank, args.world, args.backend, args.share_card)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # before the group's first collective
    dist.init_process_group(args.backend, init_method=f"file://{args.store}/store",
                            rank=args.rank, world_size=args.world)
    try:
        cfg = carve(args.world)
        mesh = create_mesh(cfg, args.backend, args.device, args.share_card)
        mesh_self_check(mesh)
        result = {"mesh": mesh.sizes}
        batches = {}
        for name, (mc, tc, batch_name, program) in _configs(mesh.sizes, args.world).items():
            axes = (dataclasses.asdict(cfg) if name == "unpacked"
                    else dict(data=-1, model=cfg.model) if name == "packed"
                    else _pipe_programs(args.world)[name][0])
            m = create_mesh(MeshConfig(**axes), args.backend, args.device, args.share_card)
            data = m.size("data")
            if data not in batches:
                batches[data] = dict(zip(("unpacked", "packed"), _batches(data)))
            result[name] = _step(mc, tc, m, batches[data][batch_name], m.device, program)
            result[name + "_data"] = data
        mc = _configs(mesh.sizes, args.world)["unpacked"][0]
        rows = local_rows(_batches(mesh.size("data"))[0], mesh)
        pipe = InferencePipeline(
            mc, build_model(mc, mesh.device, seed=0, mesh=mesh).state_dict(),
            TestConfig(pre_nms_topk=16, pre_nms_thresh=0.0, duration_thresh=0.001,
                       duration_thresh_max=90.0, max_seg_per_min=2.0),
            device=mesh.device, mesh=mesh)
        scored = pipe.score_batch(rows.visual, rows.audio, rows.text, rows.mask,
                                  rows.durations)
        result["ring_eval"] = pipe.ring
        result["scored"] = [len(scored), int(sum(len(r["scores"]) for r in scored))]
        result["finite"] = bool(all(np.isfinite(r["scores"]).all() for r in scored))
        with open(os.path.join(args.store, f"rank{args.rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def _communicate_all(procs, timeout: float):
    """communicate() on every rank, killing all of them on any failure."""
    try:
        return [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def dryrun_multichip(n_devices: int, device: str = "cuda", share_card: bool = False,
                     timeout: float = 600.0) -> str:
    """Runs the dry run on ``n_devices`` ranks (module docstring) on the
    card unless ``device`` is "cpu"; raises without a card, if a rank fails
    or if the ranks disagree, else returns a summary line."""
    dev = resolve_device(device)
    backend = "gloo" if dev.type == "cpu" or share_card else "nccl"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="dryrun_") as store:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repurpose_tpu_torch.parallel.dryrun", "--rank", str(r),
             "--world", str(n_devices), "--store", store, "--backend", backend,
             "--device", dev.type] + (["--share_card"] if share_card else []),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=root) for r in range(n_devices)]
        logs = _communicate_all(procs, timeout)
        bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"dry run ranks failed {bad}:\n" + "\n".join(
                f"--- rank {r} ---\n{logs[r][-3000:]}" for r, _ in bad))
        results = []
        for r in range(n_devices):
            with open(os.path.join(store, f"rank{r}.json")) as f:
                results.append(json.load(f))
    sizes = results[0]["mesh"]
    want = {}
    for name, (mc, tc, batch_name, _) in _configs(sizes, n_devices).items():
        data = results[0][name + "_data"]
        one_mc = dataclasses.replace(mc, attention_impl="auto" if mc.attention_impl == "ring"
                                     else mc.attention_impl)
        want[name] = _step(one_mc, dataclasses.replace(tc, batch_size=ROWS_PER_RANK * data,
                                                       shard_opt_state=False),
                           None, dict(zip(("unpacked", "packed"), _batches(data)))[batch_name],
                           dev)
    for r, got in enumerate(results):
        if not got["finite"]:
            raise RuntimeError(f"rank {r}: non-finite scores")
        for name in want:
            # float32, sums in another order: within the JAX test's rtol
            np.testing.assert_allclose(got[name][0], want[name][0], rtol=2e-3,
                                       err_msg=f"rank {r} {name} loss")
            np.testing.assert_allclose(got[name][1], want[name][1], rtol=1e-2,
                                       err_msg=f"rank {r} {name} grad_norm")
    if "1f1b_split" in want:  # the two schedules on one split state, dropout 0
        for r, got in enumerate(results):
            np.testing.assert_allclose(got["1f1b_split"][0], got["gpipe_split"][0], rtol=1e-5,
                                       err_msg=f"rank {r}: 1F1B against GPipe")
    pipes = "".join(f" | {name} loss {results[0][name][0]:.6f}"
                    for name in _pipe_programs(n_devices))
    return (f"dryrun_multichip({n_devices}) ok: mesh {sizes}, loss unpacked "
            f"{results[0]['unpacked'][0]:.6f} packed {results[0]['packed'][0]:.6f} "
            f"(one process {want['unpacked'][0]:.6f}, {want['packed'][0]:.6f}), "
            f"scored {sum(r['scored'][0] for r in results) // (sizes['model'] * sizes['seq'])} "
            f"videos{' with the ring' if results[0]['ring_eval'] else ''}{pipes}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repurpose_tpu_torch.parallel.dryrun")
    p.add_argument("--rank", type=int, default=None, help="run as this rank (internal)")
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--store", default=None)
    p.add_argument("--backend", default="gloo")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--share_card", action="store_true")
    args = p.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return 0
    print(dryrun_multichip(args.world, args.device, args.share_card))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
