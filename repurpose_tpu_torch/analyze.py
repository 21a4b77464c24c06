"""Feature analysis CLI of the port (root ``analyze.py``): the reference's
visualize_features.py and modality_correlation_analysis.py as one entry
point over ``repurpose_tpu_torch.utils.analysis``. Host tooling: nothing
runs on the card.

Per video: the temporal offset sweep of per-dimension cross-modal
correlation, highlight-vs-background correlation, the logistic-probe label
cross-correlation, and a projection (PCA / t-SNE / UMAP) of the first
video's text features coloured by label. Artifacts in ``--output-dir``:
correlation_analysis_report.txt, temporal_correlation.png and
projection_<method>.png; one JSON line on stdout. Where matplotlib cannot
be imported (the machine with the card has none) the two figures are
skipped: stderr names them, and so does the JSON line's ``skipped``; the
numbers are the same.

Usage:
    python -m repurpose_tpu_torch.analyze --synthetic 4 --output-dir /tmp/analysis
    python -m repurpose_tpu_torch.analyze --config_path configs/repurpose.yaml \\
        --split val --videos 5 --method tsne --output-dir analysis_out
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Feature analysis of a dataset split.")
    p.add_argument("--config_path", default=None)
    p.add_argument("--split", default="val", choices=("train", "val", "test"))
    p.add_argument("--videos", type=int, default=5, help="videos to analyze")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic videos instead of real features")
    p.add_argument("--method", default="pca", choices=("pca", "tsne", "umap"))
    p.add_argument("--max-offset", type=int, default=10)
    p.add_argument("--corr", default="pearson", choices=("pearson", "spearman"))
    p.add_argument("--output-dir", default="analysis_out")
    args = p.parse_args(argv)
    if not args.synthetic and not args.config_path:
        p.error("--config_path or --synthetic required")
    return args


def _dataset(args):
    import numpy as np

    if args.synthetic:
        from repurpose_tpu_torch.config import ModelConfig
        from repurpose_tpu_torch.data.synthetic import SyntheticDataset

        rng = np.random.default_rng(0)
        return SyntheticDataset(
            rng.integers(120, 400, args.synthetic).tolist(),
            ModelConfig(vis_dim=32, aud_dim=48, text_dim=16),
            seed=1, signal=1.0,
        )
    from repurpose_tpu_torch.config import load_config
    from repurpose_tpu_torch.data.dataset import RepurposeDataset

    cfg = load_config(args.config_path)
    return RepurposeDataset(getattr(cfg, f"{args.split}_dataset"), validate=False,
                            keep_gt_segments=True)


def main(argv: list[str] | None = None) -> dict:
    """Runs the analysis; prints and returns the summary."""
    from repurpose_tpu_torch.utils import analysis as an

    args = parse_args(argv)
    ds = _dataset(args)
    os.makedirs(args.output_dir, exist_ok=True)
    if min(args.videos, len(ds)) <= 0:
        raise SystemExit(
            f"no videos to analyze (dataset has {len(ds)}, --videos {args.videos})"
        )
    all_results: dict = {}
    first_sample = None
    for i in range(min(args.videos, len(ds))):
        s = ds[i]
        first_sample = first_sample or s
        streams = {m: s[m] for m in ("visual", "audio", "text")}
        all_results[s["video_id"]] = {
            "temporal": an.temporal_correlation(
                streams, max_offset=args.max_offset, method=args.corr
            ),
            "highlight_background": an.highlight_background_correlation(
                streams, s["labels"], method=args.corr
            ),
            "label_regression": an.label_cross_correlation(streams, s["labels"]),
        }

    artifacts = [an.write_report(
        all_results, os.path.join(args.output_dir, "correlation_analysis_report.txt")
    )]
    # the cross-video mean ± std curve (the reference's averaged figure)
    agg = an.aggregate_temporal([r["temporal"] for r in all_results.values()])
    fla = an.feature_label_analysis(
        first_sample["text"], first_sample["labels"], method=args.method
    )
    figures = [
        (os.path.join(args.output_dir, "temporal_correlation.png"),
         lambda path: an.render_temporal_correlation(agg, path)),
        (os.path.join(args.output_dir, f"projection_{args.method}.png"),
         lambda path: an.render_projection(fla, first_sample["labels"], path)),
    ]
    skipped = []
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        skipped = [path for path, _ in figures]
        print(f"analyze: matplotlib is not installed; skipped {', '.join(skipped)}",
              file=sys.stderr)
    else:
        artifacts += [render(path) for path, render in figures]

    summary = {
        "videos": len(all_results),
        "peak_at_zero": agg["peak_at_zero"],
        "separability_acc": fla["separability_acc"],
        "artifacts": artifacts,
        "skipped": skipped,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
