"""Feature analysis toolkit (``repurpose_tpu/utils/analysis.py``, host-side
numpy and scipy): feature-label separability, per-dimension cross-modal
correlation, lag analysis, and report artifacts, the reference's
visualize_features.py and modality_correlation_analysis.py.

- ``feature_label_analysis``: a PCA / t-SNE / UMAP projection of one
  stream, the per-dimension feature-label correlation and a logistic
  separability probe; ``render_projection`` draws it;
- ``dimension_correlation``: per-dimension-pair Pearson / Spearman over the
  first 10x10 dims, mean |r| and the fraction of significant pairs;
- ``temporal_correlation`` (offset sweep per modality pair),
  ``highlight_background_correlation``, ``label_cross_correlation`` (a
  logistic probe's scores against zero-mean labels), ``aggregate_temporal``
  (the cross-video mean and spread) and ``render_temporal_correlation``;
- ``modality_correlation`` / ``lag_analysis``: cheap norm-profile proxies;
- ``write_report``: the text report.

The machine with the card has no scikit-learn and no matplotlib, so the
port does without the first: PCA is an SVD of the centred data, and the
logistic probe is sklearn's default ``LogisticRegression`` (an L2 penalty of
C = 1 on the weights, an unpenalised intercept, L-BFGS with its tolerances)
fitted with ``scipy.optimize`` over the folds that ``cross_val_score(cv=k)``
makes (``StratifiedKFold(k)``, unshuffled). t-SNE (scikit-learn), UMAP
(umap-learn) and the renders (matplotlib) import their package inside the
function and raise an ``ImportError`` that names it where it is missing.
"""

from __future__ import annotations

import logging
from typing import Dict, Sequence

import numpy as np

logger = logging.getLogger(__name__)

MODALITY_PAIRS = (("visual", "audio"), ("visual", "text"), ("audio", "text"))


def _import(module: str, package: str, what: str):
    """``module`` imported, or an ImportError that names ``package``."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs the {package} package, which is not installed") from e


def pca(x: np.ndarray, n_components: int) -> tuple[np.ndarray, np.ndarray]:
    """(projection [N, n_components], explained variance ratio
    [n_components]) of the rows of ``x``: the SVD of the centred data, the
    component signs fixed as scikit-learn's ``PCA`` fixes them (the largest
    |loading| of each component positive)."""
    xc = x - x.mean(0)
    _, s, vt = np.linalg.svd(xc, full_matrices=False)
    signs = np.sign(vt[np.arange(vt.shape[0]), np.argmax(np.abs(vt), axis=1)])
    signs[signs == 0] = 1.0
    vt = vt * signs[:, None]
    total = np.var(x, axis=0, ddof=1).sum()
    var = s**2 / max(x.shape[0] - 1, 1)
    return xc @ vt[:n_components].T, var[:n_components] / total


class LogisticProbe:
    """scikit-learn's default ``LogisticRegression`` on two classes 0 / 1:
    the mean log-loss plus 1 / (2 C n) |w|^2 (C = 1; the intercept is not
    penalised), minimised by L-BFGS from zero with scikit-learn's options
    (``gtol`` 1e-4, ``maxls`` 50, at most ``max_iter`` iterations)."""

    def __init__(self, max_iter: int = 100, c: float = 1.0):
        self.max_iter, self.c = max_iter, c
        self.coef_ = self.intercept_ = None

    def fit(self, x: np.ndarray, y: np.ndarray) -> "LogisticProbe":
        from scipy.optimize import minimize
        from scipy.special import expit

        y = np.asarray(y).astype(int)
        if np.unique(y).size < 2:
            raise ValueError("the probe needs samples of both classes")
        x = np.asarray(x, np.float64)
        n, d = x.shape
        sign = 2.0 * y - 1.0
        reg = 1.0 / (self.c * n)

        def loss(theta):
            w, b = theta[:d], theta[d]
            m = sign * (x @ w + b)
            gz = -sign * expit(-m) / n
            value = np.logaddexp(0.0, -m).mean() + 0.5 * reg * (w @ w)
            return value, np.concatenate([x.T @ gz + reg * w, [gz.sum()]])

        res = minimize(loss, np.zeros(d + 1), jac=True, method="L-BFGS-B",
                       options=dict(maxiter=self.max_iter, maxls=50, gtol=1e-4,
                                    ftol=64 * np.finfo(float).eps))
        self.coef_, self.intercept_ = res.x[:d][None], res.x[d:]
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, np.float64) @ self.coef_[0] + self.intercept_[0] > 0).astype(int)

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y).astype(int)))


def stratified_folds(y: np.ndarray, n_splits: int) -> np.ndarray:
    """The test fold of each sample under ``StratifiedKFold(n_splits)``
    without shuffling (scikit-learn's allocation: each class's samples, in
    order, dealt to the folds as evenly as the sorted labels allow)."""
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_enc = class_perm[y_inv]
    n_classes = len(y_idx)
    if np.min(np.bincount(y_enc)) < n_splits and np.max(np.bincount(y_enc)) < n_splits:
        raise ValueError(f"n_splits={n_splits} is more than the members of every class")
    y_order = np.sort(y_enc)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    folds = np.empty(len(y), dtype=int)
    for k in range(n_classes):
        folds[y_enc == k] = np.arange(n_splits).repeat(allocation[:, k])
    return folds


def cross_val_accuracy(x: np.ndarray, y: np.ndarray, folds: int, max_iter: int) -> list[float]:
    """Accuracy of a ``LogisticProbe`` on each held-out stratified fold, as
    ``cross_val_score(LogisticRegression(max_iter=...), x, y, cv=folds)``."""
    test_fold = stratified_folds(y, folds)
    scores = []
    for i in range(folds):
        test = test_fold == i
        probe = LogisticProbe(max_iter).fit(x[~test], y[~test])
        scores.append(probe.score(x[test], y[test]))
    return scores


def feature_label_analysis(
    features: np.ndarray,  # [T, D]
    labels: np.ndarray,  # [T]
    n_components: int = 3,
    method: str = "pca",
) -> dict:
    """Projection (``method``: "pca" | "tsne" | "umap") + per-dimension
    feature-label correlation + a logistic separability probe (up to 5-fold
    mean accuracy; None where a fold cannot be fitted). The explained
    variance is PCA's under every method."""
    labels = np.asarray(labels).astype(int)
    x = np.asarray(features, np.float64)
    n_comp = min(n_components, x.shape[1], max(x.shape[0] - 1, 1))
    if method == "tsne":
        manifold = _import("sklearn.manifold", "scikit-learn", "method='tsne'")
        n_comp = min(n_comp, 3)
        proj = manifold.TSNE(
            n_components=n_comp, random_state=42,
            perplexity=min(30.0, max(2.0, (x.shape[0] - 1) / 3.0)),
            init="pca",
        ).fit_transform(x)
        explained = pca(x, n_comp)[1]
    elif method == "umap":
        umap = _import("umap", "umap-learn", "method='umap'")
        proj = umap.UMAP(n_components=n_comp, random_state=42).fit_transform(x)
        explained = pca(x, n_comp)[1]
    elif method == "pca":
        proj, explained = pca(x, n_comp)
    else:
        raise ValueError(f"bad method: {method}")

    xc = x - x.mean(0)
    lc = labels - labels.mean()
    denom = x.std(0) * labels.std() + 1e-12
    corr = (xc * lc[:, None]).mean(0) / denom

    sep = None
    if 0 < labels.sum() < len(labels):
        folds = max(2, min(5, int(labels.sum()), int((labels == 0).sum())))
        try:
            sep = float(np.mean(cross_val_accuracy(x, labels, folds, max_iter=200)))
        except ValueError as e:
            logger.debug("separability probe skipped: %s", e)
    return {
        "projection": proj,
        "method": method,
        "explained_variance": explained.tolist(),
        "label_correlation": corr,
        "top_correlated_dims": np.argsort(-np.abs(corr))[:10].tolist(),
        "separability_acc": sep,
        "positive_rate": float(labels.mean()),
    }


def _pyplot():
    matplotlib = _import("matplotlib", "matplotlib", "rendering a figure")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_projection(analysis: dict, labels: np.ndarray, out_path: str) -> str:
    plt = _pyplot()
    proj = analysis["projection"]
    fig, ax = plt.subplots(figsize=(7, 6))
    sc = ax.scatter(proj[:, 0], proj[:, 1], c=np.asarray(labels), s=4,
                    cmap="coolwarm", alpha=0.6)
    fig.colorbar(sc, label="label")
    ax.set_xlabel("PC1")
    ax.set_ylabel("PC2")
    ax.set_title(
        f"separability={analysis['separability_acc']}, "
        f"pos_rate={analysis['positive_rate']:.2f}"
    )
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def _stream_corr(a: np.ndarray, b: np.ndarray) -> float:
    """Mean canonical-ish correlation proxy: correlation of per-second
    feature-norm profiles (cheap, scale-free)."""
    pa = np.linalg.norm(a, axis=1)
    pb = np.linalg.norm(b, axis=1)
    if pa.std() < 1e-9 or pb.std() < 1e-9:
        return 0.0
    return float(np.corrcoef(pa, pb)[0, 1])


def modality_correlation(
    streams: Dict[str, np.ndarray],  # modality -> [T, D]
    labels: np.ndarray | None = None,
    shift: int = 30,
) -> dict:
    """Same-timestep vs shifted cross-modal correlation per modality pair.

    The sanity claim of the reference's correlation analysis: temporally
    ALIGNED streams should correlate more than the same streams shifted by
    ``shift`` seconds. Also reports highlight-vs-background mean-norm
    separation per modality when labels are given.
    """
    names = sorted(streams)
    t = min(s.shape[0] for s in streams.values())
    streams = {k: v[:t] for k, v in streams.items()}
    out: dict = {"pairs": {}}
    for i, a in enumerate(names):
        for b in names[i + 1 :]:
            aligned = _stream_corr(streams[a], streams[b])
            sh = min(shift, t - 1)
            shifted = _stream_corr(streams[a][sh:], streams[b][: t - sh])
            out["pairs"][f"{a}/{b}"] = {
                "aligned": aligned,
                "shifted": shifted,
                "aligned_beats_shifted": bool(aligned > shifted),
            }
    if labels is not None:
        labels = np.asarray(labels[:t]).astype(bool)
        if labels.any() and (~labels).any():
            out["highlight_separation"] = {
                k: float(
                    np.linalg.norm(v[labels], axis=1).mean()
                    - np.linalg.norm(v[~labels], axis=1).mean()
                )
                for k, v in streams.items()
            }
    return out


def lag_analysis(
    a: np.ndarray, b: np.ndarray, max_lag: int = 10
) -> dict:
    """Cross-correlation of norm profiles over lags in [-max_lag, max_lag];
    returns the lag maximizing correlation (reference lag analysis)."""
    t = min(a.shape[0], b.shape[0])
    pa = np.linalg.norm(a[:t], axis=1)
    pb = np.linalg.norm(b[:t], axis=1)
    lags = range(-max_lag, max_lag + 1)
    corrs = {}
    for lag in lags:
        if lag >= 0:
            x, y = pa[lag:], pb[: t - lag]
        else:
            x, y = pa[: t + lag], pb[-lag:]
        if len(x) > 2 and x.std() > 1e-9 and y.std() > 1e-9:
            corrs[lag] = float(np.corrcoef(x, y)[0, 1])
        else:
            corrs[lag] = 0.0
    best = max(corrs, key=lambda k: corrs[k])
    return {"correlations": corrs, "best_lag": best, "best_corr": corrs[best]}


# -- reference-parity per-dimension analyses ----------------------------------


def dimension_correlation(
    a: np.ndarray, b: np.ndarray, method: str = "pearson", max_dims: int = 10
) -> dict:
    """Per-dimension-pair correlation between two [T, D] streams — the
    reference's compute_correlation_matrix: Pearson or Spearman over the first ``max_dims`` dims of each,
    mean of |r| with NaN pairs dropped. Adds the significance the reference
    discarded: the fraction of pairs with two-sided p < 0.05 (t-test on r,
    T-2 dof)."""
    if len(a) != len(b):
        raise ValueError("Feature sequences must have same length")
    t = len(a)
    x = np.asarray(a, np.float64)[:, :max_dims]
    y = np.asarray(b, np.float64)[:, :max_dims]
    if method == "spearman":
        from scipy.stats import rankdata

        x = rankdata(x, axis=0)
        y = rankdata(y, axis=0)
    elif method != "pearson":
        raise ValueError(f"bad method: {method}")

    def standardize(m):
        sd = m.std(axis=0)
        return (m - m.mean(axis=0)) / np.where(sd > 0, sd, np.nan)

    r = standardize(x).T @ standardize(y) / t  # [Dx, Dy]
    valid = np.isfinite(r)
    if not valid.any():
        return {"mean_abs_corr": 0.0, "significant_frac": 0.0, "n_pairs": 0}
    rv = np.clip(r[valid], -0.999999, 0.999999)
    from scipy.stats import t as t_dist

    tstat = rv * np.sqrt(max(t - 2, 1) / (1.0 - rv**2))
    p = 2.0 * t_dist.sf(np.abs(tstat), max(t - 2, 1))
    return {
        "mean_abs_corr": float(np.mean(np.abs(rv))),
        "significant_frac": float(np.mean(p < 0.05)),
        "n_pairs": int(valid.sum()),
    }


def temporal_correlation(
    streams: Dict[str, np.ndarray],  # {"visual"|"audio"|"text": [T, D]}
    max_offset: int = 10,
    method: str = "pearson",
) -> dict:
    """Per-pair dimension correlation across temporal offsets — the
    reference's analyze_temporal_correlations, including its skip of
    offsets leaving <10 timesteps. Returns offset curves plus, per pair,
    whether offset 0 is the argmax (the paper's alignment sanity claim)."""
    t = min(len(v) for v in streams.values())
    out: dict = {"offsets": [], "pairs": {f"{a}_{b}": [] for a, b in MODALITY_PAIRS}}
    for offset in range(-max_offset, max_offset + 1):
        # PARITY QUIRK: the reference slices with stream1[abs(offset):] /
        # stream2[:-abs(offset)] for BOTH signs, so its -k value is
        # bit-identical to +k — the curve is mirrored, not a true
        # negative-lag correlation. Reproduced so offset curves and
        # peak_at_zero verdicts match reference output exactly.
        k = abs(offset)
        s1 = slice(k, t)
        s2 = slice(0, t - k)
        if (t - k) < 10:
            continue
        out["offsets"].append(offset)
        for a, b in MODALITY_PAIRS:
            c = dimension_correlation(streams[a][s1], streams[b][s2], method)
            out["pairs"][f"{a}_{b}"].append(c["mean_abs_corr"])
    out["peak_at_zero"] = {}
    if 0 in out["offsets"]:
        zi = out["offsets"].index(0)
        for pair, vals in out["pairs"].items():
            out["peak_at_zero"][pair] = bool(np.argmax(vals) == zi)
    return out


def highlight_background_correlation(
    streams: Dict[str, np.ndarray], labels: np.ndarray, method: str = "pearson"
) -> dict:
    """Per-pair dimension correlation restricted to highlight vs background
    seconds (the reference's analyze_highlight_vs_background). Subsets with
    <10 seconds are skipped like the reference's minimum-length guard."""
    t = min(len(v) for v in streams.values())
    labels = np.asarray(labels[:t]).astype(bool)
    out: dict = {}
    for name, sel in (("highlight", labels), ("background", ~labels)):
        if sel.sum() < 10:
            continue
        out[name] = {
            f"{a}_{b}": dimension_correlation(
                streams[a][:t][sel], streams[b][:t][sel], method
            )["mean_abs_corr"]
            for a, b in MODALITY_PAIRS
        }
    return out


def label_cross_correlation(
    streams: Dict[str, np.ndarray], labels: np.ndarray, max_lag: int = 50
) -> dict | None:
    """Logistic-score x label cross-correlation per modality and combined —
    the reference's analyze_feature_label_regression: fit a logistic probe
    (``LogisticProbe``, at most 1000 iterations), project features on its
    weights, cross-correlate with zero-mean labels over ±max_lag, report the
    peak lag/correlation and the probe's accuracy. Returns None when there
    are <10 positive seconds (the reference's guard); a modality whose probe
    cannot be fitted gets None."""
    from scipy.signal import correlate

    labels = np.asarray(labels).astype(int)
    if labels.sum() < 10:
        return None
    t = min(min(len(v) for v in streams.values()), len(labels))
    labels = labels[:t]
    mods = {k: np.asarray(v[:t], np.float64) for k, v in streams.items()}
    mods["combined"] = np.hstack(list(mods.values()))
    results: dict = {}
    for name, feats in mods.items():
        try:
            lr = LogisticProbe(max_iter=1000).fit(feats, labels)
            scores = feats @ lr.coef_.ravel()
            zm = (2 * labels - 1).astype(np.float64)
            zm = zm - zm.mean()
            cc = correlate(scores, zm, mode="full", method="auto")
            norm = np.sqrt(np.sum(scores**2) * np.sum(zm**2))
            if norm > 0:
                cc = cc / norm
            lags = np.arange(-t + 1, t)
            keep = np.abs(lags) <= max_lag
            cc, lags = cc[keep], lags[keep]
            results[name] = {
                "cross_correlation": cc.tolist(),
                "lags": lags.tolist(),
                "lr_score": lr.score(feats, labels),
                "peak_lag": int(lags[np.argmax(np.abs(cc))]),
                "peak_correlation": float(np.max(np.abs(cc))),
            }
        except ValueError as e:
            logger.warning("label_cross_correlation failed for %s: %s", name, e)
            results[name] = None
    return results


def aggregate_temporal(results: Sequence[dict]) -> dict:
    """Average per-pair offset curves ACROSS videos — the reference's
    plot_temporal_correlations plots the cross-video mean ± std, not a single
    video. Offsets align on the union;
    videos too short for an offset are excluded from that offset's mean.
    Same schema as temporal_correlation plus per-pair 'std' and 'n_videos'
    (render_temporal_correlation shades the std band when present)."""
    offsets = sorted({o for r in results for o in r["offsets"]})
    out: dict = {
        "offsets": offsets,
        "pairs": {},
        "std": {},
        "n_videos": len(results),
    }
    for pair in results[0]["pairs"]:
        mean_c, std_c = [], []
        for o in offsets:
            vals = [
                r["pairs"][pair][r["offsets"].index(o)]
                for r in results
                if o in r["offsets"]
            ]
            mean_c.append(float(np.mean(vals)))
            std_c.append(float(np.std(vals)))
        out["pairs"][pair] = mean_c
        out["std"][pair] = std_c
    out["peak_at_zero"] = {}
    if 0 in offsets:
        zi = offsets.index(0)
        for pair, vals in out["pairs"].items():
            out["peak_at_zero"][pair] = bool(np.argmax(vals) == zi)
    return out


def render_temporal_correlation(results: dict, out_path: str) -> str:
    """Offset-vs-correlation curves, one line per modality pair (the
    reference's plot_temporal_correlations figure). Accepts a single video's
    temporal_correlation dict or the cross-video aggregate_temporal dict
    (mean curve with a ±std band)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for pair, vals in results["pairs"].items():
        (line,) = ax.plot(results["offsets"], vals, marker="o", ms=3, label=pair)
        std = results.get("std", {}).get(pair)
        if std is not None:
            lo = np.asarray(vals) - np.asarray(std)
            hi = np.asarray(vals) + np.asarray(std)
            ax.fill_between(
                results["offsets"], lo, hi, color=line.get_color(), alpha=0.15
            )
    ax.axvline(0, color="gray", lw=0.8, ls="--")
    ax.set_xlabel("temporal offset (s)")
    ax.set_ylabel("mean |corr| (first 10x10 dims)")
    ax.legend()
    ax.set_title("cross-modal correlation vs offset")
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def write_report(all_results: Dict[str, dict], out_path: str) -> str:
    """Text report artifact over per-video analysis results — the reference's
    create_summary_report. Each
    value of ``all_results`` may carry keys: temporal, highlight_background,
    label_regression, feature_label."""
    import time

    lines = [
        "MODALITY CORRELATION ANALYSIS REPORT",
        "=" * 50,
        "",
        f"Analysis date: {time.strftime('%Y-%m-%d %H:%M:%S')}",
        f"Videos analyzed: {len(all_results)} ({', '.join(all_results)})",
        "",
        "TEMPORAL CORRELATION (offset 0 = same timestep):",
        "-" * 30,
    ]
    zero: Dict[str, list] = {}
    peaks: Dict[str, list] = {}
    for res in all_results.values():
        tc = res.get("temporal")
        if not tc or 0 not in tc["offsets"]:
            continue
        zi = tc["offsets"].index(0)
        for pair, vals in tc["pairs"].items():
            zero.setdefault(pair, []).append(vals[zi])
            peaks.setdefault(pair, []).append(tc["peak_at_zero"][pair])
    for pair, vals in zero.items():
        lines.append(
            f"  {pair}: {np.mean(vals):.4f} (±{np.std(vals):.4f}), "
            f"peak-at-zero in {int(np.sum(peaks[pair]))}/{len(vals)} videos"
        )
    lines += ["", "HIGHLIGHT VS BACKGROUND:", "-" * 30]
    for region in ("highlight", "background"):
        vals: Dict[str, list] = {}
        for res in all_results.values():
            hb = res.get("highlight_background", {}).get(region)
            if hb:
                for pair, v in hb.items():
                    vals.setdefault(pair, []).append(v)
        if vals:
            lines.append(f"  {region}:")
            for pair, v in vals.items():
                lines.append(f"    {pair}: {np.mean(v):.4f} (±{np.std(v):.4f})")
    lines += ["", "LABEL CROSS-CORRELATION (logistic probe):", "-" * 30]
    for vid, res in all_results.items():
        reg = res.get("label_regression")
        if not reg:
            continue
        for mod, r in reg.items():
            if r:
                lines.append(
                    f"  {vid}/{mod}: acc={r['lr_score']:.3f} "
                    f"peak_corr={r['peak_correlation']:.3f} @ lag {r['peak_lag']}"
                )
    lines += ["", "ASSESSMENT:", "-" * 20]
    aligned_ok = all(all(p) for p in peaks.values()) if peaks else False
    lines.append(
        "  Temporal alignment sanity: "
        + ("PASS — correlations peak at offset 0" if aligned_ok
           else "CHECK — some pairs do not peak at offset 0")
    )
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return out_path
