"""Preprocessing CLI of the port, the counterpart of root ``preprocess.py``
(the reference's ``python preprocessing/main_preprocessing.py --dataset ...
[--steps ...] [--verify]``):

    python -m repurpose_tpu_torch.preprocess --dataset data/train.json --steps download visual
    python -m repurpose_tpu_torch.preprocess --dataset data/val.json --verify
    python -m repurpose_tpu_torch.preprocess --split data/train.json --chunk-size 100 --out chunks/
    python -m repurpose_tpu_torch.preprocess --fanout 4 --splits-dir chunks/ --dataset-type train
    python -m repurpose_tpu_torch.preprocess --fanout 4 --splits-dir chunks/ --dry-run --limit 10

Root ``preprocess.py``'s flags, and ``--device`` (default ``cuda``: it
raises without a card; ``--device cpu`` runs the extractors on the CPU),
passed through to the fan-out's workers. ``--config`` is a YAML file (PyYAML
imported for it) or a ``.json`` file of ``PreprocessConfig``'s fields.
``--fanout`` drains the chunk files through N worker processes (``python -m
repurpose_tpu_torch.preprocess``), each dropping a per-chunk
``_SUCCESS`` / ``_FAILED`` marker; reruns skip succeeded chunks.
"""

from __future__ import annotations

import argparse
import json
import logging

from repurpose_tpu_torch import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repurpose_tpu_torch.preprocess")
    p.add_argument("--dataset", help="split JSON to process")
    p.add_argument("--steps", nargs="+", default=["download", "visual", "audio", "text"])
    p.add_argument("--config", default=None, help="preprocessing config (.yaml or .json)")
    p.add_argument("--verify", action="store_true", help="completeness scan only")
    p.add_argument("--split", help="shard a split JSON into chunks instead")
    p.add_argument("--chunk-size", type=int, default=100)
    p.add_argument("--out", default="chunks")
    p.add_argument("--fanout", type=int, metavar="N",
                   help="drain split chunks through N parallel worker "
                        "processes with per-chunk _SUCCESS/_FAILED markers")
    p.add_argument("--splits-dir", default="chunks",
                   help="directory holding *_chunk_*.json files (--fanout)")
    p.add_argument("--dataset-type", default="all",
                   help="chunk prefix filter: train/val/test/all (--fanout)")
    p.add_argument("--limit", type=int, help="process at most N chunks")
    p.add_argument("--dry-run", action="store_true",
                   help="print the worker commands without running them")
    p.add_argument("--retry-failed", action="store_true",
                   help="rerun chunks with a _FAILED marker")
    p.add_argument("--markers-dir", default=None,
                   help="marker/log directory (default: the splits dir)")
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def load_preprocess_config(path: str | None) -> dict:
    """The fields of a ``--config`` file: JSON for ``.json``, else YAML."""
    if not path:
        return {}
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f) or {}
        import yaml

        return yaml.safe_load(f) or {}


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=args.log_level.upper())
    device = resolve_device(args.device)

    if args.split:
        from repurpose_tpu_torch.preprocessing.tools import split_dataset

        paths = split_dataset(args.split, args.out, args.chunk_size)
        print(f"wrote {len(paths)} chunks to {args.out}")
        return 0

    if args.fanout:
        from repurpose_tpu_torch.preprocessing.fanout import find_chunks, run_fanout

        chunks = find_chunks(args.splits_dir, args.dataset_type)
        if not chunks:
            parser.error(f"no {args.dataset_type} chunk files in {args.splits_dir} "
                         "(run --split first)")
        summary = run_fanout(
            chunks, args.steps, workers=args.fanout, limit=args.limit,
            dry_run=args.dry_run, retry_failed=args.retry_failed,
            markers_dir=args.markers_dir, config=args.config, device=args.device,
        )
        print(json.dumps(summary, indent=2))
        return 1 if summary["failed"] else 0

    from repurpose_tpu_torch.preprocessing.pipeline import (
        PreprocessConfig,
        PreprocessingPipeline,
    )

    if not args.dataset:
        parser.error("--dataset is required (unless using --split)")
    pipeline = PreprocessingPipeline(PreprocessConfig(**load_preprocess_config(args.config)),
                                     device=device)
    if args.verify:
        print(json.dumps(pipeline.verify_features(args.dataset), indent=2))
        return 0
    results = pipeline.process_dataset(args.dataset, args.steps)
    print(json.dumps(results, indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
