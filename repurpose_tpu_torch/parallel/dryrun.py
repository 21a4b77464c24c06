"""Multi-process dry run (the counterpart of ``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n, device)`` starts ``n`` ranks as subprocesses
(``python -m repurpose_tpu_torch.parallel.dryrun --rank r ...``, the process
group over a file store) and carves the world as the JAX dry run does:
``model`` = 2 where ``n`` is even, ``seq`` = 1 (the ``seq`` axis waits for
ring attention, ROADMAP Queue 1 item 9, part 5) and ``data`` the rest. Each
rank runs, on a tiny model of the flagship's shape (8 heads):

1. the mesh self-check;
2. one dp × tp train step with ZeRO-1 on its rows of an unpacked batch and
   one on a packed batch;
3. the scoring forward and decode of its rows through ``InferencePipeline``
   on the mesh.

The parent holds every rank's losses equal and finite and equal to one
process's step on the global batch, and returns a summary line. It runs on
the card unless ``device`` is "cpu" (gloo ranks). On CUDA, ``share_card``
puts several ranks on one card over gloo; otherwise a rank needs a card of
its own (NCCL).
"""

from __future__ import annotations

import argparse
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
    """The JAX dry run's axes for ``n`` ranks, with ``seq`` = 1."""
    return MeshConfig(data=-1, model=2 if n % 2 == 0 else 1, seq=1, pipe=1)


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


def _steps(mesh, device, data: int) -> dict:
    """(loss, grad norm) of one ZeRO-1 step on each global batch of ``data``
    ranks' rows: on this rank's rows on ``mesh``, or on all of them in one
    process (``mesh`` None)."""
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.parallel.sharding import local_rows
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer
    from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

    out = {}
    for name, batch in zip(("unpacked", "packed"), _batches(data)):
        tc = TrainConfig(batch_size=ROWS_PER_RANK * (data if mesh is None else 1),
                         buckets=(BUCKET,), epochs=1, shard_opt_state=True,
                         loss_norm="batch_size", pack_sequences=name == "packed")
        model = build_model(MODEL, device, seed=0, mesh=mesh)
        opt, schedule = make_optimizer(model, tc, 1, mesh)
        if mesh is not None:
            batch = local_rows(batch, mesh)
        m = make_train_step(MODEL, tc, schedule, mesh)(
            TrainState(model, opt, mesh=mesh), batch_to_device(batch, device))
        out[name] = [float(m["loss"]), float(m["grad_norm"])]
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
        mesh = create_mesh(carve(args.world), args.backend, args.device, args.share_card)
        mesh_self_check(mesh)
        result = {"mesh": mesh.sizes, **_steps(mesh, mesh.device, mesh.size("data"))}
        rows = local_rows(_batches(mesh.size("data"))[0], mesh)
        pipe = InferencePipeline(
            MODEL, build_model(MODEL, mesh.device, seed=0, mesh=mesh).state_dict(),
            TestConfig(pre_nms_topk=16, pre_nms_thresh=0.0, duration_thresh=0.001,
                       duration_thresh_max=90.0, max_seg_per_min=2.0),
            device=mesh.device, mesh=mesh)
        scored = pipe.score_batch(rows.visual, rows.audio, rows.text, rows.mask,
                                  rows.durations)
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
    want = _steps(None, dev, results[0]["mesh"]["data"])
    for r, got in enumerate(results):
        if not got["finite"]:
            raise RuntimeError(f"rank {r}: non-finite scores")
        for name in ("unpacked", "packed"):
            # float32, sums in another order: within the JAX test's rtol
            np.testing.assert_allclose(got[name][0], want[name][0], rtol=2e-3,
                                       err_msg=f"rank {r} {name} loss")
            np.testing.assert_allclose(got[name][1], want[name][1], rtol=1e-2,
                                       err_msg=f"rank {r} {name} grad_norm")
    sizes = results[0]["mesh"]
    return (f"dryrun_multichip({n_devices}) ok: mesh {sizes}, loss unpacked "
            f"{results[0]['unpacked'][0]:.6f} packed {results[0]['packed'][0]:.6f} "
            f"(one process {want['unpacked'][0]:.6f}, {want['packed'][0]:.6f}), "
            f"scored {sum(r['scored'][0] for r in results) // sizes['model']} videos")


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
