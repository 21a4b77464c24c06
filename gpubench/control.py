"""The controls of the comparison that decides ``correct``: readings that
the comparison has to judge wrong, taken at a cell's own sizes.

    python -m gpubench.control --workload <cell> --seeds 11 12 13

For each seed it prints one JSON line of the numbers a cell compares, as
the comparison reads them when the plain reference computed in float8
(``gpubench/reference/model.py``), the precision below the
configuration's bfloat16, is put in the program's place; and, for a
training cell, when the step leaves out half of each batch's rows and
takes the mean over the rest. A step that returns its
state unchanged reads 1 on ``update_gap`` by the comparison's measure and
needs no run. The benchmark's own runs never run these.

A training cell also takes ``--program``: the program's set-up and first
steps (``gpubench/drivers/trainer.py:setup``, no window) are judged against
the same reference run, so that one process reads the program's seeds and
the control's; and ``--steps 1``: the reference follows the first step
only, and only the numbers of the first step are printed.
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import torch

from gpubench import common, traffic
from gpubench.reference import serve as ref_serve
from gpubench.reference import train as ref_train
from gpubench.reference.model import PRECISIONS
from gpubench.weights import make_weights, served_weights


def serve_readings(wl: dict, raw: dict, seed: int, device, scratch: Path) -> dict:
    """The serving comparison of the control's clips for every pool video."""
    tw, m = wl["traffic"], raw["model"]
    lengths = traffic.durations(tw["lengths"], tw["pool"], seed)
    dims = {"visual": m["vis_dim"], "audio": m["aud_dim"], "text": m["text_dim"]}
    pool = traffic.write_corpus(str(scratch / "pool"), lengths, dims, seed, device)
    first = pool["entries"][0]["youtube_id"]
    w = served_weights(m, seed, device, wl["heads"], traffic.load_features(pool, first))
    reference, served = {}, {p: [] for p in PRECISIONS}
    for e in pool["entries"]:
        f = traffic.load_features(pool, e["youtube_id"])
        reference[e["youtube_id"]] = ref_serve.outputs(w, m, f, device)
        for p in PRECISIONS:
            lg, off = ref_serve.outputs(w, m, f, device, p)
            served[p].append({"video_id": e["youtube_id"],
                              **ref_serve.clips(lg, off, len(lg), raw["test_cfg"])})
    return {p: ref_serve.judge(served[p], reference, raw["test_cfg"])[0] for p in PRECISIONS}


FIRST_STEP = ("loss_gap.first", "logit_gap", "logit_gap.rms", "grad_gap", "grad_gap.median",
              "grad_err", "grad_err.median")


def train_readings(wl: dict, raw: dict, seed: int, device, scratch: Path,
                   steps: int = 3, program: dict | None = None) -> dict:
    """The training comparison of the float8 reference, of the half-batch
    fault and of ``program`` (what the driver's set-up followed), where
    given, against the float32 reference."""
    tw, m = wl["traffic"], raw["model"]
    if program is not None:
        corpus = program["corpus"]
    else:
        lengths = traffic.durations(tw["lengths"], tw["videos"], seed)
        dims = {"visual": m["vis_dim"], "audio": m["aud_dim"], "text": m["text_dim"]}
        corpus = traffic.write_corpus(str(scratch / "corpus"), lengths, dims, seed, device)
    cfg = {"model": m, "train": common.train_settings(raw)}
    w0 = make_weights(m, seed, device)

    def summary(**kw):
        out = ref_train.summary(ref_train.follow(corpus, cfg, seed, w0, steps, device, **kw), w0)
        common.free_device()
        return out

    def judged(prog):
        gaps = ref_train.judge(prog, ref)
        if steps >= 3:
            return gaps
        worst = {k: gaps["worst"][k] for k in ("grad", "grad_err")}
        return {**{k: gaps[k] for k in FIRST_STEP}, "worst": worst}

    ref = summary()
    out = {} if program is None else {"program": judged(program["followed"])}
    out.update({p: judged(summary(precision=p)) for p in PRECISIONS})
    if cfg["train"]["batch_size"] > 1:
        out["half_batch"] = judged(summary(leave_out_half=True))
    return out


def program_steps(bench: dict, cell: dict, seed: int, device) -> dict:
    """The program's first steps as a run's set-up takes them."""
    import argparse

    from gpubench import run
    from gpubench.drivers import trainer as driver

    args = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
    ctx = run.Context(args, bench, cell, device)
    trainer, steps, corpus, followed = driver.setup(ctx)
    steps.close()
    trainer.close()
    del trainer, steps
    common.free_device()
    return {"corpus": corpus, "followed": followed, "scratch": ctx.scratch}


def readings(wl: dict, raw: dict, seed: int, device, scratch: Path, steps: int = 3,
             program=None) -> dict:
    """``program``: None, or a function of the seed that runs the program's
    set-up and returns what ``program_steps`` does (training cells)."""
    shutil.rmtree(scratch, ignore_errors=True)
    prog = None
    try:
        if wl["driver"] == "daemon":
            return serve_readings(wl, raw, seed, device, scratch)
        prog = None if program is None else program(seed)
        return train_readings(wl, raw, seed, device, scratch, steps, prog)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
        if prog is not None:
            shutil.rmtree(prog["scratch"], ignore_errors=True)


def main(argv=None) -> int:
    from gpubench import run

    p = argparse.ArgumentParser(prog="python -m gpubench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--steps", type=int, default=3, choices=(1, 3))
    p.add_argument("--program", action="store_true")
    args = p.parse_args(argv)
    run.set_cache_dirs()
    bench = run.bench_file()
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    raw = json.loads((run.ROOT / conf["file"]).read_text())
    wl = json.loads((run.WORKLOADS / f"{args.workload}.json").read_text())
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    scratch = Path(run.os.environ.get("TMPDIR") or "/tmp") / f"gpubench-control-{args.workload}"
    program = None
    if args.program:
        def program(seed):
            return program_steps(bench, cell, seed, device)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(wl, raw, seed, device, scratch, args.steps, program)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
