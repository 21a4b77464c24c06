"""The cross-modal model's cross-attention's share of its roofline in the
training cells: the least time of the work its traced records count
(``attention.cross`` spans: valid pairs, queries and keys;
``gpubench/workcount_cross.py``) over the CUDA-event time of those spans
(the two key blocks' kernels, their merge and the backward's sum)."""

from gpubench import workcount_cross
from gpubench.program import in_stretch, spans


def read(ctx):
    recs = spans(in_stretch(ctx, "train"), "attention.cross")
    if not recs or any(r.device_s is None or "pairs" not in r.ids for r in recs):
        return None
    least = sum(workcount_cross.least_seconds(
        *workcount_cross.cross_attention_needed(r.ids, ctx["model"])) for r in recs)
    return 100.0 * least / sum(r.device_s for r in recs)
