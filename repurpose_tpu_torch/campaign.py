"""One-command published-protocol accuracy campaign (the port of the JAX
package's root ``campaign.py``).

Runs the reference's published evaluation protocol (test-split scoring ->
per-video decode + Soft-NMS -> precision@tIoU over {0.5, 0.6, 0.7, 0.8, 0.9}
and the mean) end to end and writes a self-contained JSON report:

    python -m repurpose_tpu_torch.campaign --config_path configs/repurpose.yaml --torch_ckpt best.pth
    python -m repurpose_tpu_torch.campaign --config_path configs/repurpose.yaml --resume runs/x/ckpt
    python -m repurpose_tpu_torch.campaign --smoke 8 --device cpu

Stages (each recorded in the report, which is written after every stage and,
after an unexpected error, in a ``finally``):

1. **Feature scan**: per modality, which test-split videos have a loadable
   2-D non-empty ``.npy`` (pickled files count as corrupt). Missing or
   corrupt features fail the campaign up front instead of mid-eval.
2. **Protocol eval**: the published protocol through
   ``inference.evaluate_dataset`` (bucketed batches, decode and Soft-NMS on
   the device, per-video tIoU precision).
3. **Packed cross-check** (default on): re-scores the split with sequence
   packing and holds each threshold's mean to the protocol number. Packing
   gives the same results up to rounding, and precision@tIoU is a per-video
   fraction, so one boundary video whose clips move under bf16 rounding
   shifts a mean by up to 1 / len(ds): the gate allows 2 / len(ds) per
   threshold in bf16 and stays exact (1e-6) when the model runs float32.
   The report records the differences and the tolerance used.

``--smoke N`` proves the command end to end without a corpus by writing a
synthetic split into a temporary directory, removed afterwards.
``--device`` defaults to ``cuda`` and raises without a card. ``main(argv)``
loads the config from ``--config_path`` (YAML, or the same schema as
``.json``); ``run(cfg, args)`` takes a ``Config`` built in Python.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from repurpose_tpu_torch import resolve_device
from repurpose_tpu_torch.config import Config, load_config

# the packed cross-check's exact gate (float32 models), on each threshold's mean
EXACT_TOL = 1e-6


def scan_features(dataset_cfg) -> dict:
    """Per-modality completeness scan over the split's label entries: a
    feature is OK iff its .npy loads, without unpickling, as a 2-D array
    with at least one row."""
    with open(dataset_cfg.label_path) as f:
        entries = json.load(f)
    video_ids = sorted({e["youtube_id"] for e in entries})
    dirs = {
        "visual": dataset_cfg.video_path,
        "audio": dataset_cfg.audio_path,
        "text": dataset_cfg.text_path,
    }
    report: dict = {"label_entries": len(entries), "videos": len(video_ids)}
    complete = set(video_ids)
    for mod, d in dirs.items():
        ok, missing, corrupt = [], [], []
        for vid in video_ids:
            p = os.path.join(d, f"{vid}.npy")
            if not os.path.exists(p):
                missing.append(vid)
                continue
            try:
                arr = np.load(p, mmap_mode="r", allow_pickle=False)
            except (OSError, ValueError, EOFError):  # unreadable, empty, truncated, pickled
                corrupt.append(vid)
                continue
            if arr.ndim != 2 or arr.shape[0] == 0:
                corrupt.append(vid)
            else:
                ok.append(vid)
        report[mod] = {
            "ok": len(ok),
            "missing": len(missing),
            "corrupt": len(corrupt),
            # capped listings: a half-fetched corpus should not produce a
            # multi-megabyte report
            "missing_ids": missing[:20],
            "corrupt_ids": corrupt[:20],
        }
        complete &= set(ok)
    report["complete_all_modalities"] = len(complete)
    return report


def _card(device: torch.device) -> dict:
    """The device the campaign ran on: its name and, on a card, the power
    limit as ``nvidia-smi`` prints it."""
    if device.type != "cuda":
        return {"device": "cpu"}
    out = {"device": str(device), "card": torch.cuda.get_device_name(device)}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        out["nvidia_smi"] = smi.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        out["nvidia_smi"] = f"not read: {type(e).__name__}"
    return out


def _write(path: str, report: dict) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


def run_campaign(cfg: Config, params, report_path: str, *, batch_size: int | None = None,
                 crosscheck: bool = True, checkpoint: str = "",
                 device: str = "cuda") -> dict:
    """Executes the campaign against ``cfg.test_dataset`` and writes the
    report after each stage (and, on an unexpected error, with the error).
    Returns the report. Raises ``SystemExit`` if features are incomplete or
    the packed cross-check diverges past its tolerance."""
    from repurpose_tpu_torch.data.dataset import RepurposeDataset
    from repurpose_tpu_torch.inference import evaluate_dataset
    from repurpose_tpu_torch.train.loop import TIOU_THRESHOLDS

    dev = resolve_device(device)
    t0 = time.time()
    report: dict = {
        "protocol": "precision@tIoU {0.5..0.9} + mean, per-video decode + "
        "Soft-NMS (reference inference.py:37-55)",
        "checkpoint": checkpoint,
        "label_path": cfg.test_dataset.label_path,
        "torch_version": torch.__version__,
        "compute_dtype": cfg.model.compute_dtype,
        **_card(dev),
    }
    try:
        logging.info("campaign stage 1/3: feature completeness scan")
        scan = scan_features(cfg.test_dataset)
        report["feature_scan"] = scan
        _write(report_path, report)
        bad = scan["videos"] - scan["complete_all_modalities"]
        if bad:
            raise SystemExit(
                f"feature scan failed: {bad}/{scan['videos']} videos lack a "
                f"complete modality set; see {report_path} for the id lists")

        logging.info("campaign stage 2/3: published-protocol eval")
        ds = RepurposeDataset(cfg.test_dataset, validate=False, keep_gt_segments=True)
        report["eval_entries"] = len(ds)
        t1 = time.time()
        _, _, per_thr = evaluate_dataset(ds, cfg, params, batch_size=batch_size,
                                         device=device)
        means = {str(t): float(np.mean(v)) if v else 0.0 for t, v in per_thr.items()}
        mean = float(np.mean(list(means.values())))
        report["precision_at_tiou"] = means
        report["mean_precision_at_tiou"] = mean
        report["eval_wall_s"] = round(time.time() - t1, 2)
        _write(report_path, report)

        if crosscheck:
            logging.info("campaign stage 3/3: packed cross-check")
            t2 = time.time()
            _, _, per_thr_p = evaluate_dataset(ds, cfg, params, batch_size=batch_size,
                                               pack=True, device=device)
            means_p = {str(t): float(np.mean(v)) if v else 0.0 for t, v in per_thr_p.items()}
            mean_p = float(np.mean(list(means_p.values())))
            deltas = {t: abs(means_p[t] - means[t]) for t in means}
            tol = EXACT_TOL if cfg.model.compute_dtype == "float32" else 2.0 / max(len(ds), 1)
            report["packed_crosscheck"] = {
                "precision_at_tiou": means_p,
                "mean_precision_at_tiou": mean_p,
                "abs_delta": abs(mean_p - mean),
                "abs_delta_by_threshold": deltas,
                "tolerance_per_threshold": tol,
                "tolerance_rule": ("exact (float32 model)" if tol == EXACT_TOL
                                   else "2 / videos (bf16 model: one boundary video "
                                        "moves a mean by up to 1 / videos)"),
                "passed": max(deltas.values()) <= tol,
                "wall_s": round(time.time() - t2, 2),
            }
            _write(report_path, report)
            if max(deltas.values()) > tol:
                raise SystemExit(
                    f"packed cross-check diverged: per-threshold deltas {deltas} past "
                    f"{tol:.3g} (report at {report_path})")
        report["total_wall_s"] = round(time.time() - t0, 2)
    except Exception as e:  # record the failure with the stages done so far
        report["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        _write(report_path, report)
    for t in TIOU_THRESHOLDS:
        print(f"precision@tIoU={t}: {means[str(t)]:.4f}")
    print(f"mean precision@tIoU: {mean:.4f}")
    print(f"report: {report_path}")
    return report


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m repurpose_tpu_torch.campaign",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--config_path", default="configs/repurpose.yaml")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory of the port's trainer (<dir>/<step>.pt)")
    p.add_argument("--torch_ckpt", default=None, help="reference .pth checkpoint")
    p.add_argument("--report", default="campaign_report.json")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--no-crosscheck", action="store_true",
                   help="skip the packed re-score (halves the wall-clock)")
    p.add_argument("--smoke", type=int, default=0, metavar="N",
                   help="write an N-video synthetic split to a temporary directory and "
                        "run the whole campaign against it (no corpus or checkpoint needed)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--log-level", default="INFO")
    return p.parse_args(argv)


def run(cfg: Config, args: argparse.Namespace) -> dict:
    """The campaign for ``cfg`` as the flags in ``args`` say."""
    from repurpose_tpu_torch.inference import load_params

    resolve_device(args.device)  # no card: raise before anything is written
    if not (args.resume or args.torch_ckpt or args.smoke):
        raise SystemExit(
            "a checkpoint is required for a real campaign: pass --resume (the port's "
            "trainer's checkpoint directory) or --torch_ckpt (reference .pth); "
            "--smoke N runs without one")
    checkpoint = args.torch_ckpt or args.resume or "(random init: smoke)"
    params = load_params(args, cfg)
    kw = dict(batch_size=args.batch_size, crosscheck=not args.no_crosscheck,
              checkpoint=checkpoint, device=args.device)
    if not args.smoke:
        return run_campaign(cfg, params, args.report, **kw)
    from repurpose_tpu_torch.data.synthetic import write_synthetic_dataset

    with tempfile.TemporaryDirectory(prefix="campaign_smoke_") as root:
        durations = np.random.default_rng(0).integers(
            60, cfg.train.buckets[-1], args.smoke).tolist()
        split = write_synthetic_dataset(root, durations, cfg.model, seed=3)
        logging.info("smoke split at %s (%d videos)", root, args.smoke)
        return run_campaign(dataclasses.replace(cfg, test_dataset=split), params,
                            args.report, **kw)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=args.log_level.upper())
    resolve_device(args.device)
    run(load_config(args.config_path), args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
