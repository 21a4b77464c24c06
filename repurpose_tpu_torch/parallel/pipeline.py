"""GPipe pipeline parallelism over the mesh's ``pipe`` axis
(``repurpose_tpu/parallel/pipeline.py``).

Stage s of S runs encoder layers ``[s L / S, (s + 1) L / S)``. Each data
rank splits its rows into M microbatches of contiguous rows (the JAX
reshape to [M, B / M, ...]); the schedule has ``M + S - 1`` ticks: on tick
t stage s runs microbatch ``t - s``, stage 0 injecting it from the embed
and the others taking it from the activation hop of the tick before; the
last stage banks each output from tick ``S - 1`` on. The JAX schedule runs
the fill and drain ticks on clamped indices and throws their results away;
the port skips them (nothing is computed or sent there), which changes no
result.

The reverse runs in autograd: ``_GPipe`` is the autograd Function of the
whole stage schedule. Its forward banks each microbatch's stage input and
output with their graph (the residuals); its backward runs the reverse
schedule, ``M + S - 1`` ticks again, each stage back-propagating
microbatch ``M - 1`` first, its upstream gradient received from the next
stage by the mesh's hop and the gradient of its input sent to the stage
before. Each rank's hops follow the schedule, so the stages' sends and
receives pair up in the same order on both sides.

The embed (input projection, norm, PE) runs on stage 0, the only stage
that consumes it; the head (encoder norm, feature map, the two heads) runs
on every stage, on the last stage's encoder output broadcast over ``pipe``,
so every rank of the axis returns the model's outputs, as the JAX head
replicated over ``pipe`` does. Their gradients are counted once:
``reduce_pipeline_grads`` sums over ``pipe`` each parameter's gradient as
the stage that owns it computed it (a layer's on its stage, the embed's on
stage 0, the head's on the last stage) and zeros from every other stage.

Two parameter layouts, as in the JAX package:

- the standard one (``PipelinedMMCT``, the Trainer's): every stage holds
  the whole model (the same state dict as one process, so checkpoints are
  unchanged) and runs its own layers;
- the split one (``create_pipeline_train_state``): each stage holds only
  its ``L / S`` layers and their Adam moments beside the replicated rest;
  ``split_pipeline_params`` / ``merge_pipeline_params`` convert between the
  standard state dict and ``{"layers": stacked [L, ...], "rest": ...}``,
  and ``gather_pipeline_state_dict`` exports a split model's standard one.

Dropout: before each layer of each microbatch the model's dropout
generator is seeded from (the step's seed, which folds in the data rank;
the global layer; the microbatch), and the head's from (the step's seed,
L), so a stage draws the same masks wherever the microbatch runs
(``pipeline_1f1b.py`` recomputes with them). The draws differ from the
JAX ones and from one process's, as the JAX pipeline's differ from its
unpipelined model's; trajectories are compared at dropout 0.

Restrictions (``validate_pipeline``, the JAX rules and errors): ``seq`` =
1, ``attention_impl="xla"`` where ``model`` > 1, the concat fusion, no
ring attention, ``L % S == 0`` and ``B % (data M) == 0`` for the global
batch B.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repurpose_tpu_torch.config import ModelConfig
from repurpose_tpu_torch.models.encoder import apply_layer
from repurpose_tpu_torch.models.mmct import MMCT, MMCTOutput

_LAYERS = "multimodal_encoder.layers."
_EMBED = ("input_projection.", "input_norm.")


def validate_pipeline(cfg: ModelConfig, mesh, n_microbatches: int, batch: int) -> tuple[int, int]:
    """The pipeline's restrictions; returns (stages, data ranks). ``batch``
    is the global batch, every data rank's rows together."""
    ax = mesh.sizes
    s, dp = ax["pipe"], ax["data"]
    if ax["seq"] > 1:
        raise ValueError("pipeline parallelism composes with the data and model axes "
                         f"(mesh axes {ax}); set seq=1")
    if ax["model"] > 1 and cfg.attention_impl != "xla":
        raise ValueError("pipe x tensor parallelism needs attention_impl='xla' (the JAX rule: "
                         f"GSPMD partitions XLA dots over heads); got {cfg.attention_impl!r}")
    if cfg.fusion != "concat":
        raise ValueError(f"pipeline supports the concat-fusion MMCT, not {cfg.fusion!r}")
    if cfg.attention_impl == "ring":
        raise ValueError("ring attention needs the seq axis; use xla/pallas with pipe")
    if cfg.self_num_layers % s:
        raise ValueError(f"{cfg.self_num_layers} layers not divisible by {s} pipeline stages")
    if n_microbatches < 1:
        raise ValueError("n_microbatches must be >= 1")
    if batch % (dp * n_microbatches):
        raise ValueError(f"batch {batch} not divisible by data axis {dp} x microbatches "
                         f"{n_microbatches}")
    return s, dp


# -- the two layouts ------------------------------------------------------------------


def split_pipeline_params(sd: dict, n_layers: int) -> dict:
    """A standard state dict -> ``{"layers": {name: [L, ...]}, "rest": {...}}``:
    each per-layer parameter stacked over the layers (``name`` without the
    ``multimodal_encoder.layers.{i}.`` prefix), everything else as it is."""
    rest = {k: v for k, v in sd.items() if not k.startswith(_LAYERS)}
    names = [k[len(_LAYERS) + 2:] for k in sd if k.startswith(_LAYERS + "0.")]
    layers = {n: torch.stack([sd[f"{_LAYERS}{i}.{n}"] for i in range(n_layers)])
              for n in names}
    return {"layers": layers, "rest": rest}


def merge_pipeline_params(pp: dict, n_layers: int) -> dict:
    """Inverse of ``split_pipeline_params``: the standard state dict."""
    sd = dict(pp["rest"])
    for n, x in pp["layers"].items():
        for i in range(n_layers):
            sd[f"{_LAYERS}{i}.{n}"] = x[i]
    return sd


def stage_layers(model: MMCT, mesh) -> tuple[list[nn.Module], int]:
    """(this stage's encoder layers, the global index of the first): a slice
    of the whole stack in the standard layout, every layer the stage model
    holds in the split one."""
    layers = list(model.multimodal_encoder.layers)
    offset = getattr(model, "layer_offset", None)
    if offset is not None:
        return layers, offset
    n = len(layers) // mesh.size("pipe")
    s = mesh.coord("pipe")
    return layers[s * n : (s + 1) * n], s * n


def total_layers(model: MMCT) -> int:
    """L of the whole model (the stage model of the split layout holds L / S)."""
    return getattr(model, "n_layers", model.cfg.self_num_layers)


def stage_state_dict(sd: dict, cfg: ModelConfig, mesh) -> dict:
    """Stage ``coord("pipe")``'s state dict in the split layout, its layers
    renumbered from 0, from a standard state dict."""
    n = cfg.self_num_layers // mesh.size("pipe")
    first = mesh.coord("pipe") * n
    out = {k: v for k, v in sd.items() if not k.startswith(_LAYERS)}
    for k, v in sd.items():
        if k.startswith(_LAYERS):
            i, rest = k[len(_LAYERS):].split(".", 1)
            if first <= int(i) < first + n:
                out[f"{_LAYERS}{int(i) - first}.{rest}"] = v
    return out


def build_stage_model(cfg: ModelConfig, mesh, device, seed: int = 0) -> MMCT:
    """The split layout's stage model: the MMCT of ``build_model(cfg,
    seed=seed)``'s weights holding only this stage's ``L / S`` layers
    (``layer_offset`` the global index of its first) and, under tensor
    parallelism, this rank's shards."""
    from repurpose_tpu_torch.models import init_weights
    from repurpose_tpu_torch.parallel.sharding import shard_state_dict

    validate_pipeline(cfg, mesh, 1, mesh.size("data"))
    full = MMCT(cfg)
    init_weights(full, seed)
    n = cfg.self_num_layers // mesh.size("pipe")
    model = MMCT(dataclasses.replace(cfg, self_num_layers=n), mesh)
    model.layer_offset = mesh.coord("pipe") * n
    model.n_layers = cfg.self_num_layers
    model.load_state_dict(shard_state_dict(stage_state_dict(full.state_dict(), cfg, mesh), mesh),
                          strict=True)
    return model.to(device).eval()


def create_pipeline_train_state(model_cfg: ModelConfig, train_cfg, mesh, steps_per_epoch: int,
                                seed: int = 0, device="cuda"):
    """The split layout's train state: ``(TrainState, schedule)`` over a
    ``build_stage_model``, whose optimizer holds the Adam moments of this
    stage's layers and of the replicated rest only. Pair it with
    ``make_train_step`` (GPipe) or ``make_1f1b_train_step(...,
    split_layout=True)``."""
    from repurpose_tpu_torch import resolve_device
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer

    model = build_stage_model(model_cfg, mesh, resolve_device(device), seed)
    model.set_dropout_generator(torch.Generator(device=model.input_norm.weight.device)
                                .manual_seed(train_cfg.seed))
    opt, schedule = make_optimizer(model, train_cfg, steps_per_epoch, mesh)
    return TrainState(model, opt, mesh=mesh), schedule


def _whole_model(tensors: dict, model: MMCT, mesh) -> dict:
    """A split-layout stage model's ``tensors`` (by its own names: the
    stage's layers numbered from 0) as the whole model's, by standard name
    and in the standard model's order: each layer's gathered over ``pipe``
    (placed into zeros and summed; a collective)."""
    n, offset, total = len(model.multimodal_encoder.layers), model.layer_offset, model.n_layers
    split = split_pipeline_params(tensors, n)
    layers = {}
    for name, x in split["layers"].items():
        full = torch.zeros((total, *x.shape[1:]), dtype=x.dtype, device=x.device)
        full[offset : offset + n] = x
        layers[name] = mesh.all_reduce(full, "pipe")
    merged = merge_pipeline_params({"layers": layers, "rest": split["rest"]}, total)
    order, seen = [], False
    for name in tensors:  # the whole stack where the stage's stood
        if not name.startswith(_LAYERS):
            order.append(name)
        elif not seen:
            seen = True
            order += [f"{_LAYERS}{i}.{k}" for i in range(total) for k in split["layers"]]
    return {k: merged[k] for k in order}


def gather_pipeline_state_dict(model: MMCT, mesh) -> dict:
    """A split-layout stage model's whole, standard, reference-named state
    dict: its layers gathered over ``pipe`` and its tensor-parallel shards
    over ``model``. A collective."""
    from repurpose_tpu_torch.parallel.sharding import gather_state_dict

    return _whole_model(gather_state_dict(model.state_dict(), mesh), model, mesh)


# -- the schedule -------------------------------------------------------------------------


def dropout_seed_of(base: int, *words: int) -> int:
    """A seed of the dropout generator from the step's ``base`` seed and
    ``words`` (global layer and microbatch, or the head's tag)."""
    return int(np.random.SeedSequence([base % 2**32, base >> 32, *words])
               .generate_state(1, np.uint64)[0])


class StageBlock:
    """This rank's stage: its layers, run on microbatch ``m`` of a batch
    split in ``n_microbatches``, with the attention sweep of that
    microbatch (made once, shared by its layers and their recompute) and
    the dropout generator seeded per (layer, microbatch)."""

    def __init__(self, model: MMCT, mesh, n_microbatches: int, mask, seg_ids):
        self.model, self.mesh = model, mesh
        self.layers, self.offset = stage_layers(model, mesh)
        self.stage, self.stages = mesh.coord("pipe"), mesh.size("pipe")
        self.m = n_microbatches
        self.rows = mask.shape[0] // n_microbatches
        self.masks = mask.split(self.rows)
        self.segs = [None] * n_microbatches if seg_ids is None else seg_ids.split(self.rows)
        self.make_sweep = model.multimodal_encoder.make_sweep
        gen = model.dropout_generator
        self.gen = gen if model.training and model.cfg.dropout > 0 and gen is not None else None
        if model.training and model.cfg.dropout > 0 and gen is None:
            raise ValueError("pipelined dropout needs the model's dropout generator "
                             "(MMCT.set_dropout_generator): the stages seed it per layer "
                             "and microbatch")
        self.base = gen.initial_seed() if self.gen is not None else 0

    def sweep(self, m: int):
        return None if self.make_sweep is None else self.make_sweep(self.masks[m], self.segs[m])

    def seed_head(self, *words: int) -> None:
        if self.gen is not None:
            self.gen.manual_seed(dropout_seed_of(self.base, *words))

    def __call__(self, x, m: int, sweep):
        for i, layer in enumerate(self.layers):
            if self.gen is not None:
                self.gen.manual_seed(dropout_seed_of(self.base, self.offset + i, m))
            x = apply_layer(layer, x, self.masks[m], self.segs[m], sweep,
                            self.model.multimodal_encoder.remat)
        return x


class _GPipe(torch.autograd.Function):
    """The GPipe schedule of the encoder stack (module docstring). ``x`` is
    the embed's output on stage 0 and a scalar stand-in elsewhere; the
    output, the encoder's [B, T, d] of the last stage, is on every rank."""

    @staticmethod
    def forward(ctx, x, block: StageBlock, shape, dtype):
        s, n, m_micro, mesh = block.stage, block.stages, block.m, block.mesh
        train = ctx.needs_input_grad[0]
        xs = x.split(block.rows) if s == 0 else None
        spec = [((block.rows, *shape[1:]), dtype)]
        bank: list = [None] * m_micro
        outs: list = [None] * m_micro
        prev = None
        for t in range(m_micro + n - 1):
            m = t - s
            send = None
            if 0 <= m < m_micro:
                inp = xs[m] if s == 0 else prev[0]
                if train:
                    inp = inp.detach().requires_grad_()
                with torch.set_grad_enabled(train):
                    y = block(inp, m, block.sweep(m))
                if train:
                    bank[m] = (inp, y)
                if s < n - 1:
                    send = [y]
                else:
                    outs[m] = y.detach()
            if n > 1:
                recv = spec if s > 0 and 0 <= t + 1 - s < m_micro else None
                prev = mesh.hop("pipe", send=send, recv=recv)
        if s == n - 1:
            enc = torch.cat(outs)
        else:
            enc = torch.empty(shape, dtype=dtype, device=mesh.device)
        mesh.broadcast(enc, "pipe", src=n - 1)
        ctx.block, ctx.bank, ctx.spec, ctx.x_shape = block, bank, spec, x.shape
        return enc

    @staticmethod
    def backward(ctx, g):
        block, bank, spec = ctx.block, ctx.bank, ctx.spec
        s, n, m_micro, mesh = block.stage, block.stages, block.m, block.mesh
        gs = g.split(block.rows) if s == n - 1 else None
        gx: list = [None] * m_micro
        prev = None
        for t in range(m_micro + n - 1):
            m = m_micro - 1 - (t - (n - 1 - s))  # microbatch M - 1 first
            send = None
            if 0 <= m < m_micro:
                inp, y = bank[m]
                bank[m] = None
                torch.autograd.backward(y, gs[m] if s == n - 1 else prev[0])
                if s > 0:
                    send = [inp.grad]
                else:
                    gx[m] = inp.grad
            if n > 1:
                nxt = m_micro - 1 - (t + 1 - (n - 1 - s))
                recv = spec if s < n - 1 and 0 <= nxt < m_micro else None
                prev = mesh.hop("pipe", send=send, recv=recv, step=-1)
        grad_x = torch.cat(gx) if s == 0 else torch.zeros(ctx.x_shape, device=g.device)
        return grad_x, None, None, None


def pipeline_forward(model: MMCT, mesh, n_microbatches: int, visual, audio, text, mask,
                     seg_ids=None, positions=None) -> MMCTOutput:
    """The MMCT forward with its encoder pipelined over ``mesh``'s ``pipe``
    axis (module docstring): the same values as ``model(...)`` in eval
    mode, on every rank of the axis; differentiable (GPipe's reverse).
    ``model`` holds the whole stack (the standard layout) or one stage's
    (the split layout). Every rank of the axis must call it."""
    validate_pipeline(dataclasses.replace(model.cfg, self_num_layers=total_layers(model)),
                      mesh, n_microbatches, mask.shape[0] * mesh.size("data"))
    if seg_ids is not None:
        seg_ids = seg_ids.to(torch.int32)
    block = StageBlock(model, mesh, n_microbatches, mask, seg_ids)
    shape = (mask.shape[0], mask.shape[1], model.cfg.d_model)
    if block.stage == 0:
        x = model.embed(visual, audio, text, positions)
    else:
        x = torch.zeros((), device=mesh.device, requires_grad=torch.is_grad_enabled())
    enc = _GPipe.apply(x, block, shape, model.compute_dtype)
    block.seed_head(total_layers(model))
    return model.head(enc)


class PipelinedMMCT:
    """``model`` (an MMCT, standard or split layout) called through the
    GPipe forward: the model the train and eval steps call on a mesh whose
    ``pipe`` axis is > 1 (``make_train_step``, ``Trainer``)."""

    def __init__(self, model: MMCT, mesh, n_microbatches: int):
        self.model, self.mesh, self.n_microbatches = model, mesh, n_microbatches
        self.cfg = model.cfg

    def __call__(self, visual, audio, text, mask, seg_ids=None, positions=None) -> MMCTOutput:
        return pipeline_forward(self.model, self.mesh, self.n_microbatches, visual, audio, text,
                                mask, seg_ids, positions)


def _owner(name: str, stages: int) -> int | None:
    """The stage whose gradient of parameter ``name`` counts: None for an
    encoder layer (the stage that runs it), 0 for the embed, the last stage
    for the head."""
    if name.startswith(_LAYERS):
        return None
    return 0 if name.startswith(_EMBED) else stages - 1


@torch.no_grad()
def reduce_pipeline_grads(model: MMCT, mesh) -> None:
    """Every parameter's gradient summed over ``pipe`` as its owner computed
    it (module docstring), in place; the split layout's layers are the
    stage's own and stay as they are. A parameter that no stage gives a
    gradient (the reg head without the regression loss) keeps None."""
    n, s = mesh.size("pipe"), mesh.coord("pipe")
    if n == 1:
        return
    split = hasattr(model, "layer_offset")
    mine = {id(p) for layer in stage_layers(model, mesh)[0] for p in layer.parameters()}
    rows = []
    for name, p in model.named_parameters():
        if split and name.startswith(_LAYERS):
            continue
        owner = _owner(name, n)
        rows.append((p, id(p) in mine if owner is None else owner == s))
    has = torch.tensor([float(own and p.grad is not None) for p, own in rows],
                       device=mesh.device)
    has = mesh.all_reduce(has, "pipe") > 0
    rows = [(p, own) for (p, own), h in zip(rows, has.tolist()) if h]
    flat = torch.cat([(p.grad if own and p.grad is not None else torch.zeros_like(p))
                      .reshape(-1).float() for p, own in rows])
    mesh.all_reduce(flat, "pipe")
    at = 0
    for p, _ in rows:
        g = flat[at : at + p.numel()].view_as(p).to(p.dtype)
        at += p.numel()
        p.grad = g


def pipeline_grads_by_name(model: MMCT, mesh) -> dict:
    """The whole model's float32 gradients by standard name, in the standard
    model's order (zeros where a parameter has none); a split-layout
    stage's layers gathered over ``pipe`` (a collective). For the split
    layout's telemetry."""
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
             for n, p in model.named_parameters()}
    return _whole_model(grads, model, mesh) if hasattr(model, "layer_offset") else grads
