"""The port's host utilities against the JAX package's on the CPU: the
reference's per-second AP and recall (``utils/metrics.py``), the
bucket-suggestion CLI (``data/buckets.py``), the analysis toolkit
(``utils/analysis.py``, written without scikit-learn) and its CLI
(``python -m repurpose_tpu_torch.analyze``).

Tolerances: AP / recall 1e-12 (the same float64 arithmetic); PCA
projections up to each component's sign 1e-8 and the explained variance
1e-8 (an SVD against scikit-learn's PCA, float64); the separability and
probe accuracies 0.05 (the port's L-BFGS logistic probe against
scikit-learn's, both stopping at a gradient tolerance of 1e-4, can flip a
sample near the boundary); the temporal, highlight and label correlations
1e-10 (the same numpy / scipy arithmetic); the probe's peak cross-correlation
0.05 (it projects on the probe's weights).
"""

import io
import json
import os
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from repurpose_tpu.data import buckets as jax_buckets
from repurpose_tpu.utils import analysis as jax_analysis
from repurpose_tpu.utils.metrics import calculate_ap as jax_ap
from repurpose_tpu.utils.metrics import calculate_recall as jax_recall
from repurpose_tpu_torch import analyze
from repurpose_tpu_torch.config import ModelConfig
from repurpose_tpu_torch.data import buckets
from repurpose_tpu_torch.data.synthetic import SyntheticDataset
from repurpose_tpu_torch.utils import analysis
from repurpose_tpu_torch.utils.metrics import calculate_ap, calculate_recall

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden" / "metrics.json"


@pytest.mark.parametrize("case", range(len(json.load(open(GOLDEN)))))
def test_ap_and_recall_match_the_jax_functions_and_the_goldens(case):
    c = json.load(open(GOLDEN))[case]
    for port, jax_fn, key in ((calculate_ap, jax_ap, "ap"),
                              (calculate_recall, jax_recall, "recall")):
        got = port(c["preds"], c["labels"])
        assert abs(got - jax_fn(c["preds"], c["labels"])) <= 1e-12
        assert abs(got - c[key]) <= 1e-12


def test_ap_and_recall_edge_cases():
    assert calculate_ap([[0, 3]], [0, 0, 0]) == 0.0 == jax_ap([[0, 3]], [0, 0, 0])
    for segs in ([[-5, 2]], [[3, 100]], [[4, 2]], []):
        labels = [0, 1, 1, 0, 1, 1]
        assert abs(calculate_ap(segs, labels) - jax_ap(segs, labels)) <= 1e-12
        assert abs(calculate_recall(segs, labels) - jax_recall(segs, labels)) <= 1e-12


def _main_line(main, argv, monkeypatch):
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["buckets", *argv])
    with redirect_stdout(out):
        main()
    return out.getvalue()


@pytest.mark.parametrize("split", ["val", "test"])
@pytest.mark.parametrize("extra", [[], ["--n", "3", "--align", "64"]])
def test_bucket_cli_prints_the_jax_line(split, extra, monkeypatch):
    argv = [str(ROOT / "data" / f"{split}.json"), *extra]
    want = _main_line(jax_buckets.main, argv, monkeypatch)
    got = _main_line(buckets.main, argv, monkeypatch)
    assert got == want
    line = json.loads(got)
    assert line["config_snippet"] == {"tpu": {"buckets": line["buckets"]}}


def test_bucket_module_runs_as_a_script():
    import subprocess

    proc = subprocess.run(
        [sys.executable, "-m", "repurpose_tpu_torch.data.buckets", str(ROOT / "data/val.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["videos"] > 0


@pytest.fixture(scope="module")
def video():
    ds = SyntheticDataset([300, 260], ModelConfig(vis_dim=32, aud_dim=48, text_dim=16),
                          seed=1, signal=1.0)
    return ds[0], ds[1]


def _sign_aligned(a, b):
    """a with each column's sign set to b's (PCA components are defined up
    to sign)."""
    signs = np.sign(np.sum(a * b, axis=0))
    return a * np.where(signs == 0, 1.0, signs)


def test_feature_label_analysis_matches_the_jax_module(video):
    s = video[0]
    got = analysis.feature_label_analysis(s["text"], s["labels"])
    want = jax_analysis.feature_label_analysis(s["text"], s["labels"])
    assert got["projection"].shape == want["projection"].shape
    assert np.abs(_sign_aligned(got["projection"], want["projection"])
                  - want["projection"]).max() <= 1e-8
    np.testing.assert_allclose(got["explained_variance"], want["explained_variance"], atol=1e-8)
    np.testing.assert_allclose(got["label_correlation"], want["label_correlation"],
                               atol=1e-10)
    assert got["top_correlated_dims"] == want["top_correlated_dims"]
    assert abs(got["separability_acc"] - want["separability_acc"]) <= 0.05
    assert got["positive_rate"] == want["positive_rate"]


def test_stratified_folds_are_scikit_learns(video):
    from sklearn.model_selection import StratifiedKFold

    y = np.asarray(video[0]["labels"]).astype(int)
    for k in (2, 3, 5):
        folds = analysis.stratified_folds(y, k)
        for i, (_, test) in enumerate(StratifiedKFold(k).split(np.zeros(len(y)), y)):
            assert np.array_equal(np.sort(test), np.nonzero(folds == i)[0])


def test_correlations_match_the_jax_module(video):
    for s in video:
        streams = {m: s[m] for m in ("visual", "audio", "text")}
        for method in ("pearson", "spearman"):
            got = analysis.temporal_correlation(streams, 10, method)
            want = jax_analysis.temporal_correlation(streams, 10, method)
            assert got["offsets"] == want["offsets"]
            assert got["peak_at_zero"] == want["peak_at_zero"]
            for pair in want["pairs"]:
                np.testing.assert_allclose(got["pairs"][pair], want["pairs"][pair], atol=1e-10)
            got = analysis.highlight_background_correlation(streams, s["labels"], method)
            want = jax_analysis.highlight_background_correlation(streams, s["labels"], method)
            assert got.keys() == want.keys()
            for region in want:
                for pair in want[region]:
                    assert abs(got[region][pair] - want[region][pair]) <= 1e-10
        got = analysis.label_cross_correlation(streams, s["labels"])
        want = jax_analysis.label_cross_correlation(streams, s["labels"])
        assert got.keys() == want.keys()
        for mod in want:
            assert abs(got[mod]["lr_score"] - want[mod]["lr_score"]) <= 0.05
            assert abs(got[mod]["peak_correlation"] - want[mod]["peak_correlation"]) <= 0.05
            assert got[mod]["lags"] == want[mod]["lags"]


def test_norm_profile_proxies_match_the_jax_module(video):
    s = video[0]
    streams = {m: s[m] for m in ("visual", "audio", "text")}
    assert analysis.modality_correlation(streams, s["labels"]) == \
        jax_analysis.modality_correlation(streams, s["labels"])
    assert analysis.lag_analysis(s["visual"], s["audio"]) == \
        jax_analysis.lag_analysis(s["visual"], s["audio"])


def test_a_missing_package_is_named(monkeypatch, video):
    s = video[0]
    monkeypatch.setitem(sys.modules, "umap", None)
    with pytest.raises(ImportError, match="umap-learn"):
        analysis.feature_label_analysis(s["text"], s["labels"], method="umap")
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        analysis.feature_label_analysis(s["text"], s["labels"], method="tsne")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        analysis.render_temporal_correlation({"offsets": [0], "pairs": {}}, "unused.png")


def _jax_analyze(argv, monkeypatch):
    import importlib.util

    spec = importlib.util.spec_from_file_location("root_analyze", ROOT / "analyze.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", ["analyze.py", *argv])
    out = io.StringIO()
    with redirect_stdout(out):
        module.main()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_analyze_cli_matches_the_root_cli(tmp_path, monkeypatch):
    got = analyze.main(["--synthetic", "2", "--output-dir", str(tmp_path / "port")])
    want = _jax_analyze(["--synthetic", "2", "--output-dir", str(tmp_path / "jax")],
                        monkeypatch)
    assert got["videos"] == want["videos"] == 2
    assert got["peak_at_zero"] == want["peak_at_zero"]
    assert abs(got["separability_acc"] - want["separability_acc"]) <= 0.05
    assert got["skipped"] == []
    assert [os.path.basename(p) for p in got["artifacts"]] == \
        [os.path.basename(p) for p in want["artifacts"]]
    assert all(os.path.getsize(p) > 0 for p in got["artifacts"])


def test_analyze_cli_skips_the_figures_without_matplotlib(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = analyze.main(["--synthetic", "2", "--output-dir", str(tmp_path)])
    assert [os.path.basename(p) for p in got["skipped"]] == [
        "temporal_correlation.png", "projection_pca.png"]
    assert [os.path.basename(p) for p in got["artifacts"]] == [
        "correlation_analysis_report.txt"]
    assert "matplotlib" in capsys.readouterr().err
    assert sorted(os.listdir(tmp_path)) == ["correlation_analysis_report.txt"]
