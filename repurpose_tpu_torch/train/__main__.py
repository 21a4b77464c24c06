"""Training CLI of the port (the JAX package's ``train.py``).

    python -m repurpose_tpu_torch.train --config_path configs/repurpose.yaml --workdir runs/full
    python -m repurpose_tpu_torch.train --resume --workdir runs/full
    python -m repurpose_tpu_torch.train --synthetic 64 --epochs 2 --workdir runs/synth
    python -m repurpose_tpu_torch.train --synthetic 8 --epochs 1 --device cpu

``--device`` defaults to ``cuda`` and raises without a card. ``main(argv)``
parses the flags and loads the config (YAML, or the same schema as
``.json``); ``run(cfg, args)`` takes a ``Config`` built in Python instead.

``--profile`` records a ``torch.profiler`` trace of the first epoch into
``workdir/profile`` (``trace.json`` and the operator table ``ops.txt``);
``--async-ckpt`` writes checkpoints from a background thread;
``--debug-viz`` renders prediction figures at each evaluation (matplotlib);
``--wandb`` also logs to wandb, imported only then.

Several processes train one model on a mesh (``tpu: {data, model, seq,
pipe}`` in the config; the global batch is ``batch_size`` times ``data``;
``pipe`` runs the ``pipeline_schedule`` over ``pipeline_microbatches``,
``seq`` needs ``attention_impl: ring``) when launched by torchrun, one rank
per card over NCCL:

    python -m torch.distributed.run --nproc_per_node 8 -m repurpose_tpu_torch.train \
        --config_path configs/repurpose.yaml --workdir runs/ddp

or, several ranks sharing one card, over gloo:

    python -m torch.distributed.run --nproc_per_node 2 -m repurpose_tpu_torch.train \
        --synthetic 8 --epochs 1 --dist_backend gloo --share_card --workdir runs/shared

The process group starts before anything touches CUDA; rank 0 writes the
config, the metrics, the checkpoints and the export, and every rank prints
its summary line.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time

import numpy as np
import torch
import torch.distributed

from repurpose_tpu_torch.config import Config, load_config


def build_datasets(cfg: Config, synthetic: int):
    """(train, val, test): ``synthetic`` in-memory videos (val and test an
    eighth each) with durations drawn as the JAX CLI draws them, or the
    config's feature files."""
    if synthetic:
        from repurpose_tpu_torch.data.synthetic import SyntheticDataset

        rng = np.random.default_rng(cfg.train.seed)
        durations = rng.integers(60, cfg.train.buckets[-1], synthetic).tolist()
        small = max(synthetic // 8, 1)
        return (SyntheticDataset(durations[:synthetic], cfg.model, seed=1),
                SyntheticDataset(durations[:small], cfg.model, seed=2),
                SyntheticDataset(durations[:small], cfg.model, seed=3))
    from repurpose_tpu_torch.data.dataset import RepurposeDataset

    return (RepurposeDataset(cfg.train_dataset, validate=True),
            RepurposeDataset(cfg.val_dataset, validate=True),
            RepurposeDataset(cfg.test_dataset, validate=False, keep_gt_segments=True))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m repurpose_tpu_torch.train")
    p.add_argument("--config_path", default="configs/repurpose.yaml")
    p.add_argument("--workdir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic videos instead of real features")
    p.add_argument("--wandb", action="store_true", help="also log to wandb")
    p.add_argument("--profile", action="store_true",
                   help="record a torch.profiler trace of the first epoch")
    p.add_argument("--debug-viz", action="store_true",
                   help="render prediction figures at each eval")
    p.add_argument("--async-ckpt", action="store_true",
                   help="write checkpoints from a background thread")
    p.add_argument("--auto-resume", type=int, default=0, metavar="N",
                   help="on a crash, rebuild the trainer from the latest checkpoint "
                        "up to N times")
    p.add_argument("--export_torch", default=None, metavar="PATH",
                   help="after training, write the final weights as a reference-schema "
                        ".pth")
    p.add_argument("--torch_ckpt", default=None, metavar="PATH",
                   help="warm start from a reference .pth (strict load; fresh "
                        "optimizer and schedule)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dist_backend", default=None,
                   help="process-group backend under torchrun: nccl (default on cuda) "
                        "or gloo (default on cpu)")
    p.add_argument("--share_card", action="store_true",
                   help="let several ranks share one card (needs --dist_backend gloo)")
    p.add_argument("--log-level", default="INFO")
    return p.parse_args(argv)


def _workdir(args: argparse.Namespace) -> str:
    """``--workdir``, or a new timestamped one, the same on every rank."""
    workdir = args.workdir or os.path.join("runs", time.strftime("torch_%Y%m%d_%H%M%S"))
    if torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
        box = [workdir]
        torch.distributed.broadcast_object_list(box, src=0)
        workdir = box[0]
    return workdir


def run(cfg: Config, args: argparse.Namespace) -> dict:
    """Train ``cfg`` as the flags in ``args`` say; returns the fit summary."""
    from repurpose_tpu_torch.models import load_reference_checkpoint
    from repurpose_tpu_torch.train.loop import Trainer, fit_with_auto_resume

    if args.epochs:
        # the schedule anneals over cfg.train.epochs, so the override goes there
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                 epochs=args.epochs))
    from repurpose_tpu_torch.parallel.mesh import maybe_initialize_distributed
    from repurpose_tpu_torch.parallel.sharding import gather_state_dict

    maybe_initialize_distributed(args.dist_backend, args.device, args.share_card)
    workdir = _workdir(args)
    os.makedirs(workdir, exist_ok=True)
    main_rank = not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0
    if main_rank:
        with open(os.path.join(workdir, "config.json"), "w") as f:
            f.write(cfg.to_json())
    train_ds, val_ds, test_ds = build_datasets(cfg, args.synthetic)
    init_params = None
    if args.torch_ckpt:
        init_params = load_reference_checkpoint(args.torch_ckpt)
        logging.info("warm start from reference checkpoint %s", args.torch_ckpt)

    def make_trainer():
        trainer = Trainer(cfg, workdir, train_ds, val_ds, test_ds, init_params=init_params,
                          device=args.device, use_wandb=args.wandb,
                          async_checkpoints=args.async_ckpt, dist_backend=args.dist_backend,
                          share_card=args.share_card)
        trainer.debug_viz = args.debug_viz
        return trainer

    def export_torch(trainer, summary):
        if not args.export_torch:
            return
        if summary.get("preempted"):
            logging.warning("preempted before completion; skipping --export_torch")
            return
        model = gather_state_dict(trainer.state.model.state_dict(), trainer.mesh)
        if not trainer.mesh.is_main:
            return
        model = {k: v.detach().cpu() for k, v in model.items()}
        torch.save({"model": model, "epoch": int(summary.get("best_epoch", -1)),
                    "loss": float(summary.get("final_loss", 0.0) or 0.0)},
                   args.export_torch)
        print("exported reference-schema checkpoint:", args.export_torch)

    if args.auto_resume:
        return fit_with_auto_resume(make_trainer, epochs=args.epochs,
                                    max_restarts=args.auto_resume,
                                    resume_first=args.resume, on_complete=export_torch)
    trainer = make_trainer()
    if args.resume:
        trainer.resume()
    if args.profile:
        from repurpose_tpu_torch.utils.profiling import trace

        with trace(os.path.join(workdir, "profile")):
            summary = trainer.fit(epochs=trainer.start_epoch + 1)  # one epoch
        if not summary.get("preempted") and (args.epochs or cfg.train.epochs) > trainer.start_epoch:
            summary = trainer.fit(epochs=args.epochs)
    else:
        summary = trainer.fit(epochs=args.epochs)
    try:
        export_torch(trainer, summary)
    finally:
        trainer.close()
    return summary


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    summary = run(load_config(args.config_path), args)
    if torch.distributed.is_initialized():
        # one write of the line alone: the ranks share the launcher's stdout
        sys.stdout.flush()
        sys.stdout.write(f"rank {torch.distributed.get_rank()}/"
                         f"{torch.distributed.get_world_size()} training done: {summary}\n")
        sys.stdout.flush()
        torch.distributed.destroy_process_group()
    else:
        print("training done:", summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
