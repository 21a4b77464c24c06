"""Runs one cell of the benchmark once and prints its result line.

    python -m gpubench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
(at the checkout's root), its configuration (the entry's ``file``), its
workload (``gpubench/workloads/<cell>.json``: its driver, traffic and the
limits of its comparison), its driver (``gpubench/drivers/<driver>.py``)
and the reader of each per-layer metric (``gpubench/metrics/<metric>.py``).

The run loads, warms up, measures for ``--seconds`` and checks what the
timed path produced against the plain reference under
``gpubench/reference/``. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared``: each number
compared with its limit, which also close standard error. Without a CUDA
card, or with fewer cards than the cell asks for, it exits with 2 and
prints no result; where JAX or the JAX package was loaded, with 3.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WORKLOADS = HERE / "workloads"
METRICS = HERE / "metrics"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "repurpose_tpu")


def process_start() -> float:
    """The epoch time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m gpubench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def bench_file() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def applies(entry: dict, cell: str, reported: set[str] | None = None) -> bool:
    """Whether a metric entry belongs in ``cell``'s line."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry.get("moves") in reported


def load_by_path(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_loaded() -> list[str]:
    tops = {n.split(".")[0] for n in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def power_limit_w(index: int = 0) -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Context:
    """What a driver is handed: the run's arguments, the cell, its
    configuration and workload, the device, and where to write."""

    def __init__(self, args, bench: dict, cell: dict, device):
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.cell = cell
        self.name = cell["name"]
        conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
        with open(ROOT / conf["file"]) as f:
            self.config = json.load(f)
        with open(WORKLOADS / f"{self.name}.json") as f:
            self.workload = json.load(f)
        self.device = device
        self.t_start = T_START
        tmp = os.environ.get("TMPDIR") or "/tmp"
        self.scratch = Path(tmp) / f"gpubench-{self.name}"

    def say(self, line: str) -> None:
        """A line for standard output, before the result line."""
        print(line, flush=True)


def set_cache_dirs() -> None:
    """Every kernel cache at a fixed path inside the checkout. The port's
    nvcc libraries live in ``repurpose_tpu_torch/build/`` there already."""
    os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")


def main(argv=None) -> int:
    args = parse_args(argv)
    set_cache_dirs()
    bench = bench_file()
    cell = next((c for c in bench["workloads"] if c["name"] == args.workload), None)
    if cell is None:
        print(f"no cell named {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"cell {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    return run_cell(args, bench, cell, torch.device("cuda", 0))


def run_cell(args, bench: dict, cell: dict, device) -> int:
    """The run itself, on ``device`` (the card; the tests hand the CPU)."""
    ctx = Context(args, bench, cell, device)
    driver = importlib.import_module(f"gpubench.drivers.{ctx.workload['driver']}")
    out = driver.run(ctx)

    found = jax_loaded()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark runs without them",
              file=sys.stderr)
        return 3

    e2e = [m for m in bench["end_to_end"] if applies(m, ctx.name)]
    reported = {m["name"] for m in e2e}
    metrics = {}
    if ctx.trace:
        rctx = dict(out["reader"], trace=out["trace"], model=ctx.config["model"])
        for m in bench["per_layer"]:
            if not applies(m, ctx.name, reported):
                continue
            reader = load_by_path(f"gpubench_metric_{m['name']}",
                                  METRICS / f"{m['name']}.py")
            value = reader.read(rctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}

    compared = {k: {"value": v, "limit": out["limits"][k]} for k, v in out["compared"].items()}
    correct = out["sound"] and all(
        not math.isnan(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch_name(device), "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"],
           "power_limit_w": power_limit_w() if device.type == "cuda" else None}
    line = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    if ctx.trace:
        tr = out["trace"]
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
        ctx.say(f"traced stretch: {tr.window_s:.6f} s on the profiler's clock, "
                f"{tr.wall_s:.6f} s on the host's")
    line["compared"] = compared
    for k, c in compared.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {bool(correct)}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


def torch_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    raise SystemExit(main())
