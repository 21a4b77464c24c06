"""Validation debugger: per-sample prediction visualization + health checks.

Capability parity with the reference's ValidationDebugger
(utils/debug_visualizer.py:10-241): collects per-sample predictions, renders
a 3-panel matplotlib figure (classification probability curve with GT marks;
predicted vs GT boundary offsets; predicted vs GT segment spans), writes JSON
debug logs with loss statistics, and raises the **model-collapse warning**
when the regression head's output std drops below 0.1
(debug_visualizer.py:197,225-226 — the symptom of the untrained reg head
saturating its ReLU).

matplotlib uses the Agg backend (headless) and is imported only when a
figure is rendered; figures land under ``{workdir}/debug/{tag}/``.

A copy of ``repurpose_tpu/utils/debug_viz.py`` (numpy only), so that the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Sequence

import numpy as np

logger = logging.getLogger(__name__)

COLLAPSE_STD_THRESHOLD = 0.1


class ValidationDebugger:
    def __init__(self, workdir: str, tag: str = ""):
        tag = tag or time.strftime("%Y%m%d_%H%M%S")
        self.dir = os.path.join(workdir, "debug", tag)
        os.makedirs(os.path.join(self.dir, "visualizations"), exist_ok=True)
        os.makedirs(os.path.join(self.dir, "logs"), exist_ok=True)
        self.samples: list[dict] = []

    def add_sample(
        self,
        video_id: str,
        probs: np.ndarray,  # [T] sigmoid cls probabilities (valid region)
        offsets: np.ndarray,  # [T, 2] predicted (left, right)
        gt_labels: np.ndarray,  # [T]
        gt_offsets: np.ndarray,  # [T, 2]
        pred_segments: np.ndarray | None = None,  # [N, 2]
        gt_segments: Sequence[Sequence[float]] | None = None,
        loss: float | None = None,
    ) -> None:
        self.samples.append(
            dict(
                video_id=video_id,
                probs=np.asarray(probs),
                offsets=np.asarray(offsets),
                gt_labels=np.asarray(gt_labels),
                gt_offsets=np.asarray(gt_offsets),
                pred_segments=None if pred_segments is None else np.asarray(pred_segments),
                gt_segments=gt_segments,
                loss=loss,
            )
        )

    # -- health checks -----------------------------------------------------------

    def check_model_collapse(self) -> list[str]:
        """Collapse check over the POOLED offsets of all collected samples
        (reference debug_visualizer.py:197,225-226 stacks every sample's
        offsets and takes one np.std) — per-sample stds would fire on
        individually-flat-but-differently-centered videos where the
        reference stays silent, and vice versa. Per-sample stds ride along
        in the warning for debuggability."""
        warnings = []
        if self.samples:
            pooled = np.concatenate([s["offsets"].ravel() for s in self.samples])
            std = float(pooled.std())
            if std < COLLAPSE_STD_THRESHOLD:
                per = ", ".join(
                    f"{s['video_id']}={float(s['offsets'].std()):.4f}"
                    for s in self.samples[:10]
                )
                warnings.append(
                    f"pooled offset std {std:.4f} < {COLLAPSE_STD_THRESHOLD} "
                    f"— possible reg-head collapse (per-sample: {per})"
                )
        for w in warnings:
            logger.warning("model-collapse check: %s", w)
        return warnings

    # -- artifacts ----------------------------------------------------------------

    def render(self, max_samples: int = 10) -> list[str]:
        """Write 3-panel PNGs; returns file paths."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        paths = []
        for s in self.samples[:max_samples]:
            t = np.arange(len(s["probs"]))
            fig, axes = plt.subplots(3, 1, figsize=(14, 9), sharex=True)

            ax = axes[0]
            ax.plot(t, s["probs"], lw=0.8, label="pred prob")
            pos = s["gt_labels"] > 0.5
            ax.scatter(t[pos], np.ones(pos.sum()) * 1.02, s=2, c="tab:red", label="GT positive")
            ax.set_ylabel("cls prob")
            ax.set_ylim(-0.05, 1.1)
            ax.legend(loc="upper right", fontsize=7)

            ax = axes[1]
            ax.plot(t, s["offsets"][:, 0], lw=0.7, label="pred left")
            ax.plot(t, s["offsets"][:, 1], lw=0.7, label="pred right")
            ax.plot(t, s["gt_offsets"][:, 0], lw=0.7, ls="--", label="gt left")
            ax.plot(t, s["gt_offsets"][:, 1], lw=0.7, ls="--", label="gt right")
            ax.set_ylabel("offsets (s)")
            ax.legend(loc="upper right", fontsize=7)

            ax = axes[2]
            if s["gt_segments"]:
                for a, b in s["gt_segments"]:
                    ax.axvspan(a, b, ymin=0.55, ymax=0.95, color="tab:green", alpha=0.4)
            if s["pred_segments"] is not None:
                for a, b in s["pred_segments"]:
                    ax.axvspan(a, b, ymin=0.05, ymax=0.45, color="tab:blue", alpha=0.4)
            ax.set_yticks([0.25, 0.75])
            ax.set_yticklabels(["pred", "GT"])
            ax.set_xlabel("time (s)")
            fig.suptitle(f"{s['video_id']} (loss={s['loss']})")
            p = os.path.join(self.dir, "visualizations", f"{s['video_id']}.png")
            fig.savefig(p, dpi=100, bbox_inches="tight")
            plt.close(fig)
            paths.append(p)
        return paths

    def write_log(self) -> str:
        """JSON summary: loss stats, prob/offset stats, collapse warnings."""
        losses = [s["loss"] for s in self.samples if s["loss"] is not None]
        summary = {
            "n_samples": len(self.samples),
            "loss": {
                "mean": float(np.mean(losses)) if losses else None,
                "min": float(np.min(losses)) if losses else None,
                "max": float(np.max(losses)) if losses else None,
            },
            "prob_stats": {
                "mean": float(np.mean([s["probs"].mean() for s in self.samples]))
                if self.samples else None,
            },
            "offset_std": {
                s["video_id"]: float(s["offsets"].std()) for s in self.samples
            },
            "collapse_warnings": self.check_model_collapse(),
        }
        p = os.path.join(self.dir, "logs", "summary.json")
        with open(p, "w") as f:
            json.dump(summary, f, indent=2)
        return p
