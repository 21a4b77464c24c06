"""The cross-attention's kernel route (``flash_attention`` over two key
blocks: one kernel forward a block, merged by their LSEs, then one prep and
one kernel backward a block on the merged out and lse) on the card, against its plain version: one
softmax over the whole 2T context in float32 at the kernels' rounding points
(``flash_forward_reference``'s forward and ``_bwd_terms``' backward,
computed in chunks of queries so that [1, 32768] fits). Marked ``gpu``; each
test skips (in its fixture) where no card is visible. Run on a machine with
an H100:

    python -m pytest --noconftest -m gpu tests/test_torch_cross_route_gpu.py

(``--noconftest``: the repository's conftest imports JAX, which that machine
does not have.) This file imports neither JAX nor PyYAML.

Inputs as the model gives them: bf16 q, k, v at Dh 64 (the tensor-core
kernels: the dense ones at T = 2048, the stream forward and the fused
backward past it), the upstream gradient 0 on rows at or past kvl. The plain
backward takes the route's own out and lse, as the kernels' tests do.

Tolerances, on max |route - plain| as a fraction of max |plain|, the
kernels' bf16 ones (tests/test_torch_flash_bwd_stream_gpu.py): 1e-2 for
out, dq, dk and dv (bf16 outputs, one ulp 2**-8 relative, and a last-bit
difference in a score can flip a bf16 rounding of p or ds; the merge rounds
out to bf16 once more, and at T <= 2048 so does the sum of the blocks' dq),
and 1e-2 absolute on lse.
"""

import pytest
import torch

from repurpose_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu

REL_TOL = 1e-2
LSE_ATOL = 1e-2
CHUNK = 1024  # query rows of the plain version at a time


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repurpose_tpu_torch  # noqa: F401  (switches TF32 off)


def _inputs(b, t, fills, seed=0, n=2):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, t, 8, 64), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((b, n * t, 8, 64), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    kv = torch.zeros((b, t), dtype=torch.bool, device="cuda")
    for i, f in enumerate(fills):
        kv[i, : int(f * t)] = True
    return q, k, v, kv


def _plain(q, k, v, kv, o, lse, g, sm: str):
    """(out, lse, dq, dk, dv) of one softmax over the n T keys."""
    b, t, h, dh = q.shape
    scale = dh ** -0.5
    kv_all = kv.repeat(1, k.shape[1] // t)
    bias = torch.where(kv_all, 0.0, fa.NEG_INF)[:, None, None, :]
    out = torch.zeros(q.shape, device=q.device)
    lse_p = torch.full(lse.shape, fa.SKIP_LSE, device=q.device)
    dq = torch.zeros(q.shape, device=q.device)
    dk, dv = torch.zeros(k.shape, device=q.device), torch.zeros(v.shape, device=q.device)
    for r0 in range(0, t, CHUNK):
        r = slice(r0, r0 + CHUNK)
        qs = (q[:, r].float() * scale).to(q.dtype)
        s = (torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float()) + bias).to(fa._SM_DTYPES[sm])
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        den = e.sum(dim=-1, keepdim=True, dtype=torch.float32)
        out[:, r] = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), v.float()) \
            / den.permute(0, 2, 1, 3)
        lse_p[:, :, r] = m.float() + torch.log(den)
        del s, e
        _, p, ds = fa._bwd_terms(q[:, r], k, v, kv_all, o[:, r], lse[:, :, r], g[:, r], None,
                                 sm, scale)
        dq[:, r] = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float()) * scale
        dk += torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qs.float())
        dv += torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(), g[:, r].float())
        del p, ds
    past = torch.arange(t, device=q.device)[None, :] >= fa._kv_len(kv)
    out[past] = 0.0
    dq[past] = 0.0
    lse_p.masked_fill_(past[:, None, :, None], fa.SKIP_LSE)
    return out, lse_p, dq, dk, dv


def _run(q, k, v, kv, sm, seed=1):
    """The route's out, lse (its forward's merge) and gradients."""
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*qkv, kv, None, sm)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda").bfloat16()
    g = g.masked_fill(torch.arange(q.shape[1], device="cuda")[None, :, None, None]
                      >= fa._kv_len(kv)[:, :, None, None], 0.0)
    out.backward(g)
    o, lse = fa.flash_forward(q, k, v, kv, None, sm)
    assert torch.equal(o, out.detach())
    return o, lse, g, [x.grad for x in qkv]


def _rel(got, want):
    return float((got.float() - want).abs().max()) / max(float(want.abs().max()), 1e-12)


@pytest.mark.parametrize("sm", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,t,fills", [(1, 4096, (0.9,)), (2, 2048, (1.0, 0.55)),
                                       (1, 32768, (0.9,))])
def test_cross_route_matches_one_softmax_over_the_context(cuda, b, t, fills, sm):
    q, k, v, kv = _inputs(b, t, fills)
    o, lse, g, grads = _run(q, k, v, kv, sm)
    want = _plain(q, k, v, kv, o, lse, g, sm)
    for name, got, w in zip(("out", "dq", "dk", "dv"), (o, *grads), (want[0], *want[2:])):
        assert torch.isfinite(got).all(), name
        assert _rel(got, w) <= REL_TOL, (name, _rel(got, w))
    live = lse < fa.SKIP_LSE
    assert torch.equal(live, want[1] < fa.SKIP_LSE)
    assert float((lse[live] - want[1][live]).abs().max()) <= LSE_ATOL


def test_a_row_with_both_key_blocks_empty_merges_to_zero(cuda):
    q, k, v, kv = _inputs(2, 2048, (0.7, 0.0), seed=3)
    o, lse, g, (dq, dk, dv) = _run(q, k, v, kv, "bfloat16")
    assert torch.all(o[1] == 0) and torch.all(lse[1] == fa.SKIP_LSE)
    assert all(torch.isfinite(x).all() for x in (dq, dk, dv))
    assert torch.all(dq[1] == 0) and torch.all(dk[1] == 0) and torch.all(dv[1] == 0)
    want = _plain(q, k, v, kv, o, lse, g, "bfloat16")
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want[2:]):
        assert _rel(got, w) <= REL_TOL, (name, _rel(got, w))


@pytest.mark.parametrize("t", [2048, 4096])
def test_the_route_launches_one_kernel_a_block(cuda, t):
    q, k, v, kv = _inputs(1, t, (0.8,))
    names = ("flash_forward", "flash_fwd_tc", "flash_fwd_stream_tc", "flash_bwd_stream_prep",
             "flash_bwd_fused_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")
    for name in names:
        getattr(fa, name).launches = 0
    sweep = fa.attention_sweep(kv)
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*qkv, kv, None, "bfloat16", sweep=sweep)
    out.backward(torch.ones_like(out).masked_fill(~kv[:, :, None, None], 0.0))
    got = {name: getattr(fa, name).launches for name in names}
    if t > fa.STREAM_MAX_T:
        want = dict(flash_forward=0, flash_fwd_tc=0, flash_fwd_stream_tc=2,
                    flash_bwd_stream_prep=1, flash_bwd_fused_tc=2, flash_bwd_dq_tc=0,
                    flash_bwd_dkv_tc=0)
    else:
        want = dict(flash_forward=2, flash_fwd_tc=2, flash_fwd_stream_tc=0,
                    flash_bwd_stream_prep=1, flash_bwd_fused_tc=0, flash_bwd_dq_tc=2,
                    flash_bwd_dkv_tc=2)
    assert got == want
