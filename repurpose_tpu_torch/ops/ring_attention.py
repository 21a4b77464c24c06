"""Ring attention (``repurpose_tpu/ops/ring_attention.py``): exact masked
attention with the sequence split over the mesh's ``seq`` axis.

Each rank holds ``T / n`` positions of q, k, v and the key mask. The
forward folds its own key block first, then makes ``n - 1`` rotations
(``Mesh.rotate``: every rank sends its current block on and receives the
previous rank's), folding each visiting block into an online softmax:
float32 scores, a running maximum and denominator, as the JAX ring does.
The key-padding mask travels with its block, as an additive ``NEG_INF``
bias, so a shard whose keys are all masked adds nothing and every output
stays finite.

The backward (``RingAttention.backward``) keeps only the shard's own q, k,
v, mask, output and log-sum-exp: ``delta`` is ``dout . out`` per query,
each visiting block's probabilities are rebuilt from the saved
log-sum-exp, dq accumulates locally, and dk / dv ride around the ring with
their blocks (``n - 1`` rotations) before one final hop takes each home.

The JAX package computes the ring with XLA einsums, outside any Pallas
kernel, and so does the port: plain ``torch`` products in float32. Heads
stay local under tensor parallelism (``model`` > 1): a rank runs the ring
on its own heads. The block hops cross ranks through the mesh's hop
(NCCL isend / irecv, or under gloo staged through host memory).
"""

from __future__ import annotations

import torch

from repurpose_tpu_torch.ops.attention import NEG_INF


def _scale(dh: int) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.tensor(dh, dtype=torch.float32))


def _scores(qf, k, m, scale):
    """float32 scores [B, H, Tq, Tk] of the local queries against one key
    block, masked keys biased by ``NEG_INF``."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float()) * scale.to(qf.device)
    return s + torch.where(m[:, None, None, :], 0.0, NEG_INF)


def _ring_forward(q, k, v, key_valid, mesh):
    """(out [B, Tq, H, Dh] in q's dtype, lse [B, H, Tq] float32)."""
    b, tq, h, dh = q.shape
    scale = _scale(dh)
    qf = q.float()
    acc = torch.zeros((b, h, tq, dh), dtype=torch.float32, device=q.device)
    m_max = torch.full((b, h, tq), float("-inf"), dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)

    def fold(k_cur, v_cur, m_cur, acc, m_max, denom):
        s = _scores(qf, k_cur, m_cur, scale)
        new_max = torch.maximum(m_max, s.amax(dim=-1))
        corr = torch.exp(m_max - new_max)
        p = torch.exp(s - new_max[..., None])
        denom = denom * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_cur.float())
        return acc, new_max, denom

    blk = (k, v, key_valid)
    acc, m_max, denom = fold(*blk, acc, m_max, denom)
    for _ in range(mesh.size("seq") - 1):  # rotate first, then fold
        blk = mesh.rotate(blk, "seq")
        acc, m_max, denom = fold(*blk, acc, m_max, denom)
    out = acc / denom.clamp(min=1e-30)[..., None]
    lse = m_max + torch.log(denom.clamp(min=1e-30))
    return out.transpose(1, 2).to(q.dtype), lse


class RingAttention(torch.autograd.Function):
    """``ring_attention``'s forward and its flash-style ring backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, mesh):
        out, lse = _ring_forward(q, k, v, key_valid, mesh)
        ctx.mesh = mesh
        ctx.save_for_backward(q, k, v, key_valid, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_valid, out, lse = ctx.saved_tensors
        mesh = ctx.mesh
        scale = _scale(q.shape[-1])
        qf, dof = q.float(), dout.float()
        delta = torch.einsum("bqhd,bqhd->bhq", dof, out.float())

        def fold(k_cur, v_cur, m_cur, dk_cur, dv_cur, dq):
            kf, vf = k_cur.float(), v_cur.float()
            p = torch.exp(_scores(qf, kf, m_cur, scale) - lse[..., None])
            dv_cur = dv_cur + torch.einsum("bhqk,bqhd->bkhd", p, dof)
            ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale.to(q.device)
            dk_cur = dk_cur + torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale.to(q.device)
            return dk_cur, dv_cur, dq

        zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        dk, dv, dq = fold(k, v, key_valid, zeros(k), zeros(v), zeros(q))
        blk = (k, v, key_valid)
        for _ in range(mesh.size("seq") - 1):
            # dk / dv ride with their block, gathering every rank's queries
            *blk, dk, dv = mesh.rotate((*blk, dk, dv), "seq")
            dk, dv, dq = fold(*blk, dk, dv, dq)
        if mesh.size("seq") > 1:  # after n - 1 hops rank i holds block i + 1's: one more home
            dk, dv = mesh.rotate((dk, dv), "seq")
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_valid: torch.Tensor, mesh) -> torch.Tensor:
    """Attention of this rank's ``T / n`` queries [B, T/n, H, Dh] over the
    whole sequence, whose keys, values and key mask [B, T/n] are split the
    same way over ``mesh``'s ``seq`` axis (rank c holding positions
    ``[c T/n, (c + 1) T/n)``); output [B, T/n, H, Dh] in q's dtype. Every
    rank of the axis must call it."""
    return RingAttention.apply(q, k, v, key_valid.bool(), mesh)
