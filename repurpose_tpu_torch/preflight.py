"""Pre-flight checks before training (root ``preflight.py``, the reference's
test_multi_gpu.py that its launch scripts run first), on one card or, under
torchrun, on every rank of the launch:

1. the device inventory: the card's name, the device count and the power
   limit (``nvidia-smi``);
2. the kernel build: every ``csrc/*.cu`` compiled and loaded
   (``native.build_all``);
3. a collective self-check: ``all_reduce`` over a process group of one
   (NCCL on the card, gloo on the CPU) equals the device count; under
   torchrun, ``mesh_self_check`` over the launch's world and each axis;
4. the reduced model (2 layers at the flagship width) and one train step on
   synthetic data;
5. the capacity model: the estimated peak of the flagship train step per
   bucket against the device's memory, and the largest safe bucket;
6. under torchrun (two ranks or more): one dp × tp train step of the
   reduced model on a mesh of ``model`` = 2 (where the world is even) and
   ``data`` = the rest, its loss finite and equal on every rank;
7. under torchrun on an even world: one pipeline-parallel (dp x pp)
   train step of the reduced model on a mesh of ``pipe`` = 2 and ``data``
   the rest, with ``attention_impl="xla"`` and 2 microbatches (GPipe), its
   loss finite and equal on every rank;
8. with ``--full``: the flagship forward at bucket 2048, and the measured
   peak of the packed [6, 2048] production step beside its estimate.

Run as ``python -m repurpose_tpu_torch.preflight [--full] [--output-json
PATH] [--device cuda|cpu] [--dist_backend nccl|gloo] [--share_card]``. It
prints a summary line per check and exits 0 only if every check passed.
On the CPU (``--device cpu``) the kernel build is not needed (the wrappers
run their plain versions) and the capacity model reads the host's memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time


def _production_model():
    """The flagship model of ``configs/repurpose.yaml``: bf16 activations,
    the kernels' attention."""
    from repurpose_tpu_torch.config import ModelConfig

    return ModelConfig(attention_impl="auto", compute_dtype="bfloat16")


def check_devices(dev) -> str:
    import torch

    if dev.type != "cuda":
        return f"cpu ({os.cpu_count()} cores)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    print(f"  {smi[dev.index or 0].strip()}")
    return f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(dev)}"


def check_build(dev) -> str:
    if dev.type != "cuda":
        return "not needed on the CPU: the kernel wrappers run their plain versions"
    from repurpose_tpu_torch import native

    names = native.build_all()
    for n in names:
        native.load(n)
    return f"{len(names)} sources built and loaded ({', '.join(names)})"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_collectives(dev, backend: str | None = None, share_card: bool = False) -> str:
    """all_reduce of a one over a process group of this process alone, on
    one device: the sum is the device count of the group, 1. Under torchrun,
    the mesh self-check over the launch's ranks instead."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        from repurpose_tpu_torch.config import MeshConfig
        from repurpose_tpu_torch.parallel.mesh import create_mesh, mesh_self_check

        mesh = create_mesh(MeshConfig(data=-1), backend, dev, share_card)
        return f"{mesh.backend} all_reduce={mesh_self_check(mesh)} over {mesh.world} ranks"
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        x = torch.ones(1, device=dev)
        dist.all_reduce(x)
        total, devices = int(x.item()), dist.get_world_size()
    finally:
        dist.destroy_process_group()
    if total != devices:
        raise RuntimeError(f"all_reduce gave {total}, not the device count {devices}")
    return f"{backend} all_reduce={total}"


def check_train_step(dev) -> str:
    from repurpose_tpu_torch.config import TrainConfig
    from repurpose_tpu_torch.data.batching import collate
    from repurpose_tpu_torch.data.synthetic import SyntheticDataset
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer
    from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

    mc = dataclasses.replace(_production_model(), self_num_layers=2)
    tc = TrainConfig(batch_size=2, buckets=(256,))
    ds = SyntheticDataset([100, 150], mc, seed=0)
    batch = batch_to_device(collate([ds[0], ds[1]], tc.buckets, 2), dev)
    model = build_model(mc, dev, seed=0)
    optimizer, schedule = make_optimizer(model, tc, 1)
    metrics = make_train_step(mc, tc, schedule)(TrainState(model, optimizer), batch)
    loss = float(metrics["loss"])
    if not 0 < loss < 1e9:
        raise RuntimeError(f"loss {loss}")
    return f"loss={loss:.2f}"


def check_parallel_step(dev, backend: str | None = None, share_card: bool = False) -> str:
    """One train step of the reduced model on a dp × tp mesh of the launch's
    ranks (``model`` = 2 where the world is even, ``data`` the rest), each
    data rank on its rows of a global batch; the loss finite and the same
    on every rank."""
    import torch
    import torch.distributed as dist

    from repurpose_tpu_torch.config import MeshConfig, TrainConfig
    from repurpose_tpu_torch.data.batching import collate
    from repurpose_tpu_torch.data.synthetic import SyntheticDataset
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.parallel.mesh import create_mesh
    from repurpose_tpu_torch.parallel.sharding import local_rows
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer
    from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

    world = dist.get_world_size()
    mesh = create_mesh(MeshConfig(data=-1, model=2 if world % 2 == 0 else 1), backend, dev,
                       share_card)
    mc = dataclasses.replace(_production_model(), self_num_layers=2)
    tc = TrainConfig(batch_size=2, buckets=(256,))
    n = tc.batch_size * mesh.size("data")
    ds = SyntheticDataset([100 + 10 * i for i in range(n)], mc, seed=0)
    batch = local_rows(collate([ds[i] for i in range(n)], tc.buckets, n), mesh)
    model = build_model(mc, mesh.device, seed=0, mesh=mesh)
    model.set_dropout_generator(torch.Generator(device=mesh.device).manual_seed(tc.seed))
    optimizer, schedule = make_optimizer(model, tc, 1, mesh)
    metrics = make_train_step(mc, tc, schedule, mesh)(
        TrainState(model, optimizer, mesh=mesh), batch_to_device(batch, mesh.device))
    loss = metrics["loss"].reshape(1)
    spread = torch.cat([loss, -loss])
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    if not 0 < float(loss) < 1e9 or float(spread[0] + spread[1]) != 0.0:
        raise RuntimeError(f"loss {float(loss)}, largest {float(spread[0])} and smallest "
                           f"{float(-spread[1])} over the ranks")
    return f"data={mesh.size('data')} model={mesh.size('model')} loss={float(loss):.2f}"


def check_pipeline_step(dev, backend: str | None = None, share_card: bool = False) -> str:
    """One GPipe train step of the reduced model (2 layers, the plain
    attention, 2 microbatches) on a mesh of ``pipe`` = 2 and ``data`` the
    rest, each data rank on its rows of a global batch of 2 rows a data
    rank (root ``preflight.py``'s dp x pp check); the loss finite and the
    same on every rank."""
    import torch
    import torch.distributed as dist

    from repurpose_tpu_torch.config import MeshConfig, TrainConfig
    from repurpose_tpu_torch.data.batching import collate
    from repurpose_tpu_torch.data.synthetic import SyntheticDataset
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.parallel.mesh import create_mesh
    from repurpose_tpu_torch.parallel.sharding import local_rows
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer
    from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

    mesh = create_mesh(MeshConfig(data=-1, pipe=2), backend, dev, share_card)
    dp = mesh.size("data")
    mc = dataclasses.replace(_production_model(), self_num_layers=2, attention_impl="xla")
    tc = TrainConfig(batch_size=2, buckets=(256,), pipeline_microbatches=2,
                     pipeline_schedule="gpipe")
    n = tc.batch_size * dp
    ds = SyntheticDataset([100 + i for i in range(n)], mc, seed=0)
    batch = local_rows(collate([ds[i] for i in range(n)], tc.buckets, n), mesh)
    model = build_model(mc, mesh.device, seed=0, mesh=mesh)
    model.set_dropout_generator(torch.Generator(device=mesh.device).manual_seed(tc.seed))
    optimizer, schedule = make_optimizer(model, tc, 1, mesh)
    metrics = make_train_step(mc, tc, schedule, mesh)(
        TrainState(model, optimizer, mesh=mesh), batch_to_device(batch, mesh.device))
    loss = metrics["loss"].reshape(1)
    spread = torch.cat([loss, -loss])
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    if not 0 < float(loss) < 1e9 or float(spread[0] + spread[1]) != 0.0:
        raise RuntimeError(f"loss {float(loss)}, largest {float(spread[0])} and smallest "
                           f"{float(-spread[1])} over the ranks")
    return f"stages=2 dp={dp} loss={float(loss):.2f}"


def _memory_bytes(dev) -> float:
    """The device's memory: the card's, or the host's on the CPU."""
    from repurpose_tpu_torch.utils.capacity import device_memory_bytes

    if dev.type == "cuda":
        return device_memory_bytes(dev)
    return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def check_capacity(dev) -> str:
    from repurpose_tpu_torch.config import TrainConfig
    from repurpose_tpu_torch.utils.capacity import capacity_table, max_safe_bucket

    mc, tc = _production_model(), TrainConfig()
    mem = _memory_bytes(dev)
    print(f"  memory/device: {mem / 1e9:.1f} GB (flagship, batch {tc.batch_size})")
    for row in capacity_table(mc, tc.batch_size, tc.buckets, mem):
        print(f"    bucket {row['bucket']:>5}: est {row['est_gb']:>6.2f} GB "
              f"-> {'fits' if row['fits'] else 'DOES NOT FIT'}")
    best = max_safe_bucket(mc, tc.batch_size, mem)
    remat_best = max_safe_bucket(dataclasses.replace(mc, remat=True), tc.batch_size, mem)
    accum_best = max_safe_bucket(mc, tc.batch_size, mem, grad_accum_steps=tc.batch_size,
                                 grad_accum_dtype="bfloat16")
    print(f"    max safe bucket: {best} (remat=true extends to {remat_best}; "
          f"grad_accum_steps={tc.batch_size} + bf16 accumulators to {accum_best})")
    return f"max_bucket={best} remat_max={remat_best} accum_max={accum_best}"


def check_flagship_forward(dev) -> str:
    import numpy as np
    import torch

    from repurpose_tpu_torch.models import build_model

    mc = _production_model()
    rng = np.random.default_rng(0)
    t = 2048
    feats = [torch.from_numpy(rng.normal(0, 1, (1, t, n)).astype(np.float32)).to(dev)
             for n in (mc.vis_dim, mc.aud_dim, mc.text_dim)]
    mask = torch.ones(1, t, dtype=torch.bool, device=dev)
    with torch.no_grad():
        out = build_model(mc, dev, seed=0)(*feats, mask)
    if not all(bool(torch.isfinite(x).all()) for x in out):
        raise RuntimeError("non-finite outputs")
    return f"out={[tuple(x.shape) for x in out]}"


def check_measured_memory(dev) -> str:
    from repurpose_tpu_torch.config import TrainConfig
    from repurpose_tpu_torch.utils.capacity import estimate_train_bytes, measured_memory

    mc, tc = _production_model(), TrainConfig(batch_size=6, pack_sequences=True)
    mem = measured_memory(mc, tc, 2048, dev)
    est = estimate_train_bytes(mc, 6, 2048)["total_bytes"]
    if est < mem["peak_bytes"]:
        raise RuntimeError(f"estimate {est / 1e9:.2f} GB below the measured peak "
                           f"{mem['peak_bytes'] / 1e9:.2f} GB")
    return (f"measured peak {mem['peak_bytes'] / 1e9:.2f} GB, estimate {est / 1e9:.2f} GB "
            f"(ratio {est / mem['peak_bytes']:.2f})")


CHECKS = [("devices", check_devices), ("kernel build", check_build),
          ("collective self-check", check_collectives),
          ("reduced model + train step", check_train_step),
          ("device memory capacity model", check_capacity)]
FULL_CHECKS = [("flagship forward (bucket 2048)", check_flagship_forward),
               ("flagship measured memory (packed [6, 2048])", check_measured_memory)]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Pre-flight checks before training.")
    p.add_argument("--full", action="store_true",
                   help="also run the flagship forward and measure the step's memory")
    p.add_argument("--output-json", default=None, help="also write the results as JSON")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dist_backend", default=None,
                   help="process-group backend under torchrun (nccl on cuda, gloo on cpu)")
    p.add_argument("--share_card", action="store_true",
                   help="let several ranks share one card (needs --dist_backend gloo)")
    args = p.parse_args(argv)

    import functools

    import torch

    from repurpose_tpu_torch import resolve_device
    from repurpose_tpu_torch.parallel.mesh import maybe_initialize_distributed

    distributed = maybe_initialize_distributed(args.dist_backend, args.device, args.share_card)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and distributed:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh_kw = dict(backend=args.dist_backend, share_card=args.share_card)
    checks = [(name, functools.partial(fn, **mesh_kw) if fn is check_collectives else fn)
              for name, fn in CHECKS]
    if distributed:
        checks.append(("dp x tp train step", functools.partial(check_parallel_step, **mesh_kw)))
        if torch.distributed.get_world_size() % 2 == 0:
            checks.append(("pipeline-parallel step (dp x pp)",
                           functools.partial(check_pipeline_step, **mesh_kw)))
    results: list[tuple[str, bool, str]] = []
    for name, fn in checks + (FULL_CHECKS if args.full else []):
        t0 = time.time()
        try:
            detail = fn(dev) or ""
            results.append((name, True, f"{detail} ({time.time() - t0:.1f}s)"))
        except Exception as e:  # a failed check is reported, and fails the run
            results.append((name, False, f"{type(e).__name__}: {e}"))

    rank = torch.distributed.get_rank() if distributed else 0
    print(f"\n=== preflight summary{f' (rank {rank})' if distributed else ''} ===")
    ok = True
    for name, passed, detail in results:
        print(f"  [{'PASS' if passed else 'FAIL'}] {name}: {detail}")
        ok &= passed
    if args.output_json and rank == 0:
        with open(args.output_json, "w") as f:
            json.dump([{"check": n, "passed": p, "detail": d} for n, p, d in results], f,
                      indent=2)
    if distributed:
        torch.distributed.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
