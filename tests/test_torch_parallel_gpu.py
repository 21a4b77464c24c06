"""The port's data, tensor, pipeline and sequence parallelism on the card (``gpu``: skips
without one; no JAX, so it runs with ``--noconftest`` where JAX is absent).
The CPU tests of the same code are ``tests/test_torch_parallel.py``."""

import pytest
import torch

from repurpose_tpu_torch.config import ModelConfig
from repurpose_tpu_torch.parallel import mesh as pmesh
from repurpose_tpu_torch.parallel.dryrun import dryrun_multichip


@pytest.mark.gpu
def test_dryrun_with_two_ranks_sharing_the_card():
    """dp x tp on the card (model=2: the attention kernels at 4 of 8 heads,
    float32: the first designs), two ranks sharing it over gloo."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    msg = dryrun_multichip(2, "cuda", share_card=True)
    assert "'model': 2" in msg, msg


@pytest.mark.gpu
def test_more_ranks_than_cards_raise_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="share_card"):
        pmesh.rank_device("cuda", 0, cards + 1, "nccl", share_card=False)
    assert pmesh.rank_device("cuda", cards, cards + 1, "gloo", share_card=True).index == 0


PIPE_AND_RING_WORKER = r'''
import numpy as np
from repurpose_tpu_torch.config import MeshConfig, TrainConfig
from repurpose_tpu_torch.data.batching import Batch
from repurpose_tpu_torch.models import build_model
from repurpose_tpu_torch.ops.ring_attention import ring_attention
from repurpose_tpu_torch.parallel.mesh import create_mesh
from repurpose_tpu_torch.parallel.pipeline_1f1b import make_1f1b_train_step
from repurpose_tpu_torch.train.state import TrainState, make_optimizer
from repurpose_tpu_torch.train.step import batch_to_device
import test_torch_parallel_gpu as t

torch.cuda.set_device(0)
out = {}
mesh = create_mesh(MeshConfig(data=1, pipe=2), "gloo", "cuda", share_card=True)
tc = TrainConfig(**t.PIPE_TRAIN)
model = build_model(t.PIPE_MODEL, mesh.device, seed=0, mesh=mesh)
opt, schedule = make_optimizer(model, tc, 1, mesh)
step = make_1f1b_train_step(t.PIPE_MODEL, tc, schedule, mesh, tc.pipeline_microbatches)
m = step(TrainState(model, opt, mesh=mesh), batch_to_device(t.pipe_batch(), mesh.device))
out["pipe"] = [float(m["loss"]), float(m["grad_norm"])]
mesh = create_mesh(MeshConfig(data=1, seq=2), "gloo", "cuda", share_card=True)
q, k, v, mask = t.ring_inputs(mesh.device)
w = q.shape[1] // 2
cols = slice(rank * w, (rank + 1) * w)
q, k, v = (x[:, cols].detach().requires_grad_() for x in (q, k, v))
o = ring_attention(q, k, v, mask[:, cols], mesh)
(o.float() ** 2).sum().backward()
out["ring"] = {n: x.detach().cpu() for n, x in (("out", o), ("dq", q.grad), ("dk", k.grad),
                                                 ("dv", v.grad))}
torch.save(out, f"{root}/out{world}_rank{rank}.pt")
dist.destroy_process_group()
'''
PIPE_MODEL = ModelConfig(vis_dim=16, aud_dim=24, text_dim=8, d_model=64, self_num_layers=4,
                         num_heads=4, d_ff=128, hidden_dim=16, compute_dtype="float32",
                         attn_softmax_dtype="float32", dropout=0.0)
PIPE_TRAIN = dict(batch_size=4, buckets=(128,), epochs=1, lr=1e-3, loss_norm="batch_size",
                  pipeline_microbatches=2)


def pipe_batch():
    from repurpose_tpu_torch.data.batching import collate
    from repurpose_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset([128, 100, 90, 60], PIPE_MODEL, seed=0)
    return collate([ds[i] for i in range(4)], (128,), 4)


def ring_inputs(device):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 256, 4, 16), generator=gen).to(device) for _ in range(3))
    mask = torch.ones((1, 256), dtype=torch.bool, device=device)
    mask[:, 200:] = False
    return q, k, v, mask


@pytest.mark.gpu
def test_pipe_and_ring_with_two_ranks_sharing_the_card(tmp_path):
    """A 1F1B step on pipe = 2 (the attention kernels' first designs at
    float32, per stage) and the ring op on seq = 2, two ranks sharing the
    card over gloo, against one process on the card: the step's loss and
    norm, the ring's output and gradients (float32, within 1e-5 of each
    tensor's largest element)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repurpose_tpu_torch.config import TrainConfig
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.ops.attention import mha_torch
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer
    from repurpose_tpu_torch.train.step import batch_to_device, make_train_step
    import gloo_world

    got = gloo_world.results(gloo_world.start(PIPE_AND_RING_WORKER, tmp_path, (2,)), tmp_path,
                             timeout=600)[2]
    tc = TrainConfig(**PIPE_TRAIN)
    model = build_model(PIPE_MODEL, "cuda", seed=0)
    opt, schedule = make_optimizer(model, tc, 1)
    m = make_train_step(PIPE_MODEL, tc, schedule)(TrainState(model, opt),
                                                  batch_to_device(pipe_batch(), "cuda"))
    for g in got:
        assert g["pipe"][0] == pytest.approx(float(m["loss"]), rel=1e-5)
        assert g["pipe"][1] == pytest.approx(float(m["grad_norm"]), rel=1e-4)
    q, k, v, mask = (x.requires_grad_() if x.is_floating_point() else x
                     for x in ring_inputs("cuda"))
    o = mha_torch(q, k, v, mask)
    (o.float() ** 2).sum().backward()
    valid = mask[0].cpu()
    for name, want in (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        whole = torch.cat([g["ring"][name] for g in got], dim=1)[0]
        w = want.detach().cpu()[0]
        torch.testing.assert_close(whole[valid], w[valid], rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


NCCL_WORKER = r'''
from repurpose_tpu_torch.config import MeshConfig, TrainConfig
from repurpose_tpu_torch.models import build_model
from repurpose_tpu_torch.ops.ring_attention import ring_attention
from repurpose_tpu_torch.parallel.mesh import create_mesh
from repurpose_tpu_torch.parallel.pipeline_1f1b import make_1f1b_train_step
from repurpose_tpu_torch.parallel.sharding import local_rows
from repurpose_tpu_torch.train.state import TrainState, make_optimizer
from repurpose_tpu_torch.train.step import batch_to_device, make_train_step
import test_torch_parallel_gpu as t

out = {}
for name, axes, schedule in t.NCCL_STEPS[world]:
    mesh = create_mesh(MeshConfig(**axes), "nccl", "cuda")
    tc = TrainConfig(**(t.PIPE_TRAIN | {"batch_size": 4 // mesh.size("data")}))
    model = build_model(t.PIPE_MODEL, mesh.device, seed=0, mesh=mesh)
    opt, schedule_fn = make_optimizer(model, tc, 1, mesh)
    step = (make_1f1b_train_step(t.PIPE_MODEL, tc, schedule_fn, mesh, tc.pipeline_microbatches)
            if schedule == "1f1b" else make_train_step(t.PIPE_MODEL, tc, schedule_fn, mesh))
    m = step(TrainState(model, opt, mesh=mesh),
             batch_to_device(local_rows(t.pipe_batch(), mesh), mesh.device))
    out[name] = [float(m["loss"]), float(m["grad_norm"])]
mesh = create_mesh(MeshConfig(data=world // 2, seq=2), "nccl", "cuda")
q, k, v, mask = t.ring_inputs(mesh.device)
w = q.shape[1] // 2
cols = slice(mesh.coord("seq") * w, (mesh.coord("seq") + 1) * w)
q, k, v = (x[:, cols].detach().requires_grad_() for x in (q, k, v))
o = ring_attention(q, k, v, mask[:, cols], mesh)
(o.float() ** 2).sum().backward()
out["ring"] = {n: x.detach().cpu() for n, x in (("out", o), ("dq", q.grad), ("dk", k.grad),
                                                 ("dv", v.grad))}
out["seq"] = mesh.coord("seq")
torch.save(out, f"{root}/out{world}_rank{rank}.pt")
dist.destroy_process_group()
'''
# world -> (name, mesh axes, schedule): every hop pattern of the schedules,
# pipe = 4's middle stages sitting out most ticks
NCCL_STEPS = {
    2: [("pipe2_1f1b", dict(data=1, pipe=2), "1f1b"), ("pipe2_gpipe", dict(data=1, pipe=2), "gpipe")],
    4: [("data2_pipe2_1f1b", dict(data=2, pipe=2), "1f1b"),
        ("data2_pipe2_gpipe", dict(data=2, pipe=2), "gpipe"),
        ("pipe4_1f1b", dict(data=1, pipe=4), "1f1b"), ("pipe4_gpipe", dict(data=1, pipe=4), "gpipe")],
}


@pytest.mark.gpu
def test_pipe_and_ring_over_nccl(tmp_path):
    """The hops over NCCL (``batch_isend_irecv``), one rank per card on two
    or four cards: 1F1B and GPipe steps on pipe = 2, data = 2 x pipe = 2
    and pipe = 4, and the ring op on seq = 2, against one process on the
    card (float32: the loss within 1e-5, the norm within 1e-4, the ring's
    output and gradients within 1e-5 of each tensor's largest element)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        pytest.skip("needs two CUDA cards (NCCL refuses two ranks on one)")
    from repurpose_tpu_torch.config import TrainConfig
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.ops.attention import mha_torch
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer
    from repurpose_tpu_torch.train.step import batch_to_device, make_train_step
    import gloo_world

    world = 4 if cards >= 4 else 2
    got = gloo_world.results(gloo_world.start(NCCL_WORKER, tmp_path, (world,), backend="nccl"),
                             tmp_path, timeout=600)[world]
    tc = TrainConfig(**PIPE_TRAIN)
    model = build_model(PIPE_MODEL, "cuda", seed=0)
    opt, schedule = make_optimizer(model, tc, 1)
    m = make_train_step(PIPE_MODEL, tc, schedule)(TrainState(model, opt),
                                                  batch_to_device(pipe_batch(), "cuda"))
    for name, _, _ in NCCL_STEPS[world]:
        for g in got:
            assert g[name][0] == pytest.approx(float(m["loss"]), rel=1e-5), name
            assert g[name][1] == pytest.approx(float(m["grad_norm"]), rel=1e-4), name
    q, k, v, mask = (x.requires_grad_() if x.is_floating_point() else x
                     for x in ring_inputs("cuda"))
    o = mha_torch(q, k, v, mask)
    (o.float() ** 2).sum().backward()
    valid = mask[0].cpu()
    for name, want in (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        w = want.detach().cpu()[0]
        for data in range(world // 2):
            pair = sorted(got[2 * data : 2 * data + 2], key=lambda g: g["seq"])
            whole = torch.cat([g["ring"][name] for g in pair], dim=1)[0]
            torch.testing.assert_close(whole[valid], w[valid], rtol=0,
                                       atol=1e-5 * float(w.abs().max()))
