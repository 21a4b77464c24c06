"""Driver of the cross-modal training cells: ``gpubench/drivers/trainer.py``
on the cross-modal model (``fusion: cross``).

The run is trainer.py's, step for step: its set-up (the corpus written from
the seed, the port's ``Trainer`` over its own ``BatchLoader``, the
workload's warm-up steps through ``Trainer._fit_loop``'s body, the first
three steps' losses, logits, first gradient and change followed) and its
window. Only two names differ: the weights are this model's
(``gpubench/reference/cross.py:weights``, the port's initialisation law
over the variant's parameter names), and the plain reference that follows
the first three steps is ``gpubench/reference/cross.py:follow``. trainer.py
gives no argument for either, so its ``setup`` and ``run`` are taken here
with those module names bound to this model's.

Workload keys: trainer.py's.
"""

from __future__ import annotations

import types

from gpubench import common
from gpubench.drivers import trainer
from gpubench.reference import cross
from gpubench.reference import train as ref_train


def _rebound(fn, **names):
    """trainer.py's ``fn`` with the module-level ``names`` it looks up
    replaced."""
    return types.FunctionType(fn.__code__, {**fn.__globals__, **names}, fn.__name__,
                              fn.__defaults__, fn.__closure__)


def judge(ctx, corpus: dict, followed: dict) -> dict:
    """The reference's first ``trainer.FOLLOWED`` steps against the program's."""
    m = ctx.config["model"]
    w0 = cross.weights(m, ctx.seed, ctx.device)
    ref = ref_train.summary(cross.follow(
        corpus, {"model": m, "train": common.train_settings(ctx.config)}, ctx.seed, w0,
        trainer.FOLLOWED, ctx.device), w0)
    ctx.say("losses: program " + " ".join(repr(x) for x in followed["losses"])
            + "; reference " + " ".join(repr(x) for x in ref["losses"]))
    return ref_train.judge(followed, ref)


setup = _rebound(trainer.setup, make_weights=cross.weights)
run = _rebound(trainer.run, setup=setup, judge=judge)
