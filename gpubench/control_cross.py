"""The control of the cross-modal training cells' comparison
(``gpubench/control.py`` on ``gpubench/reference/cross.py``):

    python -m gpubench.control_cross --workload <cell> --seeds 11 12 13 [--program] [--steps 1]

For each seed it prints one JSON line of the numbers the cell compares, as
the comparison reads them when the plain reference computed in float8 (the
precision below the configuration's bfloat16) is put in the program's
place and, with ``--program``, for the program's own set-up and first steps
(``gpubench/drivers/trainer_cross.py:setup``), all against one float32
reference run. The cells' batch is one video, so control.py's half-batch
fault has nothing to leave out. ``--steps 1``: the reference follows the
first step only, and only the first step's numbers are printed. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import torch

from gpubench import common, control, traffic
from gpubench.reference import cross
from gpubench.reference import train as ref_train
from gpubench.reference.model import PRECISIONS


def program_steps(bench: dict, cell: dict, seed: int, device) -> dict:
    """The program's first steps as a run's set-up takes them."""
    from gpubench import run
    from gpubench.drivers import trainer_cross

    args = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
    ctx = run.Context(args, bench, cell, device)
    trainer, steps, corpus, followed = trainer_cross.setup(ctx)
    steps.close()
    trainer.close()
    del trainer, steps
    common.free_device()
    return {"corpus": corpus, "followed": followed, "scratch": ctx.scratch}


def readings(wl: dict, raw: dict, seed: int, device, scratch: Path, steps: int = 3,
             program=None) -> dict:
    """The float8 reference's gaps and, where ``program`` (a function of the
    seed, as ``program_steps``) is given, the program's, for one seed."""
    shutil.rmtree(scratch, ignore_errors=True)
    prog = None
    try:
        m = raw["model"]
        if program is not None:
            prog = program(seed)
            corpus = prog["corpus"]
        else:
            tw = wl["traffic"]
            lengths = traffic.durations(tw["lengths"], tw["videos"], seed)
            dims = {"visual": m["vis_dim"], "audio": m["aud_dim"], "text": m["text_dim"]}
            corpus = traffic.write_corpus(str(scratch / "corpus"), lengths, dims, seed, device)
        cfg = {"model": m, "train": common.train_settings(raw)}
        w0 = cross.weights(m, seed, device)

        def summary(**kw):
            out = ref_train.summary(cross.follow(corpus, cfg, seed, w0, steps, device, **kw), w0)
            common.free_device()
            return out

        def judged(followed):
            gaps = ref_train.judge(followed, ref)
            if steps >= 3:
                return gaps
            worst = {k: gaps["worst"][k] for k in ("grad", "grad_err")}
            return {**{k: gaps[k] for k in control.FIRST_STEP}, "worst": worst}

        ref = summary()
        out = {} if prog is None else {"program": judged(prog["followed"])}
        out.update({p: judged(summary(precision=p)) for p in PRECISIONS})
        return out
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
        if prog is not None:
            shutil.rmtree(prog["scratch"], ignore_errors=True)


def main(argv=None) -> int:
    from gpubench import run

    p = argparse.ArgumentParser(prog="python -m gpubench.control_cross")
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
