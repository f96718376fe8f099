"""Pipeline-parallel prediction: the SwinV2 block-pair stack split over the
stage ranks of a data row.

Counterpart of ``swift_tpu/parallel/pipeline.py``. The JAX package runs S
stages on the devices of one process as one ``shard_map``'d scan whose
carry rotates by ``ppermute``; here each stage is a process (a rank of the
``pipe`` axis, ``parallel.mesh.init_layout(pipe=S)``) that holds the
embeddings, the head and only its own pairs (``SwinV2(pipe_stages=S,
pipe_stage=s)``, weights by :func:`stage_state_dict`), and the schedule is
the JAX one, tick by tick:

* the batch is split into M microbatches (``n_micro``, default S);
  microbatch k enters stage 0 at tick k and leaves stage S−1 at tick
  k + S − 1, S + M − 1 ticks in all, so (S − 1)/(M + S − 1) of a stage's
  ticks are idle (the bubble);
* stage 0 runs the embeddings (``stage="embed"``) on the microbatch,
  every stage its pairs (``stage="pairs"``), stage S−1 the head
  (``stage="head"``). The JAX program runs embed and head on every stage
  and discards what the other stages compute; here only the stages that
  use them run them (a departure in the schedule, not in the function);
* after each tick each stage hands (h in ``dtype`` (mb, gh, gw, dim), the
  fp32 cond (mb, dim)) to the next: a ``broadcast`` from the sender over
  the two ranks of that edge (``Layout.next_group``), issued in
  increasing edge order (a stage receives before it sends), so no
  transfer waits on a later one at any S;
* the fp32 output (B, H, W, C) is broadcast from stage S−1 to every stage
  of the data row (JAX returns the whole output to every device), so each
  rank's sampler carries on alike.

Each transfer and the delivery is a ``torch.autograd.Function`` whose
backward sends the gradient of (h, cond) back upstream over the same
edge, so the forward is differentiable: a stage's pair gradients stay on
it; the replicated parameters (embeddings, latent MLP, head) get gradients
on the stage that ran them, and :func:`reduce_replicated_grads` sums them
over the pipe group, as JAX's psum does. Zero-element tokens chain a
stage's sends (and its receives) so that their backward runs in the
reverse of the forward's order on both ranks of an edge. Every rank
computes the same loss from the delivered output, so the delivery's
backward takes the last stage's own gradient and the other stages'
nothing.

With ``data_axis="data"`` x is the global batch of every data row, as in
the JAX function: data rank d pipelines its rows ``[d·B/D, (d+1)·B/D)``
and the rows meet in one exact all-reduce of -0.0-padded buffers over the
data group; the gradient of the output passes to each rank's own rows.
``generate`` needs no data axis here: its ensemble gives each data row its
own members (``sampling.ensemble``).

The port runs one card a stage process, where the JAX package runs the
stages on the devices of one process, so ``generate --pp S`` needs S ranks
(a world that S divides). Transfers use only ``broadcast`` and
``all_reduce`` (``parallel.mesh``'s rule), which gloo runs on CUDA tensors
too, so two stages can share a card.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from swift_torch.parallel import mesh as meshlib

# a block's entries in a state dict: "[model.]transformer.layers.<i>.<rest>"
_LAYER = re.compile(r"(^|\.)transformer\.layers\.(\d+)\.")


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """A pipelined forward's description, carried by a precond
    (``models.precond._Precond.pipeline``) so every sampler path engages
    PP unchanged. ``mesh``: the rank layout (None: ``mesh.layout()`` at
    call time)."""

    mesh: Optional[meshlib.Layout] = None
    pipe_axis: str = "pipe"
    n_micro: Optional[int] = None
    data_axis: Optional[str] = None


def pipelined_precond(precond, mesh: Optional[meshlib.Layout] = None, *,
                      pipe_axis: str = "pipe", n_micro: Optional[int] = None,
                      data_axis: Optional[str] = None):
    """A copy of ``precond`` (sharing its weights) whose model forward runs
    through :func:`pipelined_swinv2_forward`; its model must be this rank's
    stage."""
    out = copy.copy(precond)
    out.pipeline = PipelineSpec(mesh=mesh, pipe_axis=pipe_axis, n_micro=n_micro,
                                data_axis=data_axis)
    return out


def stage_state_dict(sd: Mapping[str, torch.Tensor], depth: int, stages: int,
                     stage: int) -> dict:
    """Stage ``stage`` of ``stages``'s entries of a whole network's state
    dict (reference names, with or without the precond's ``model.``): every
    entry outside the blocks, and blocks ``[stage·depth/stages,
    (stage+1)·depth/stages)`` renumbered from 0, as ``SwinV2(pipe_stages=
    stages, pipe_stage=stage)`` names them."""
    per = depth // stages
    lo = stage * per
    out = {}
    for name, v in sd.items():
        m = _LAYER.search(name)
        if m is None:
            out[name] = v
            continue
        i = int(m.group(2))
        if lo <= i < lo + per:
            out[name[:m.start(2)] + str(i - lo) + name[m.end(2):]] = v
    return out


def reduce_replicated_grads(net: torch.nn.Module, mesh: Optional[meshlib.Layout] = None) -> None:
    """Sum the gradients of the parameters every stage holds (all but the
    blocks) over the pipe group, in place: each ran on one stage (the
    embeddings and latent MLP on the first, the head on the last), so the
    sums are one stage's gradients, exactly. A parameter without a gradient
    takes zeros. A collective over the pipe group; a no-op without one."""
    lay = mesh if mesh is not None else meshlib.layout()
    if lay.pipe == 1:
        return
    grads = []
    for name, p in net.named_parameters():
        if _LAYER.search(name) or not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    meshlib.all_reduce_sum(grads, lay.pipe_group)


def transfer(tensors: list[torch.Tensor], src: int, group) -> None:
    """Each of ``tensors`` (contiguous, on the model's device) overwritten
    by global rank ``src``'s over ``group``, one broadcast each."""
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


def _new_token(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(0, device=like.device)


class _Send(torch.autograd.Function):
    """Forward: (h, cond) from this stage (rank ``src``) to the next (rank
    ``dst``) over their edge ``group``; a token out. Backward: their
    gradients from the next stage."""

    @staticmethod
    def forward(ctx, token, group, src, dst, h, cond):
        ctx.group, ctx.src, ctx.dst = group, src, dst
        ctx.like = (h.shape, h.dtype, cond.shape, cond.dtype)
        transfer([h.contiguous(), cond.contiguous()], src, group)
        return _new_token(token)

    @staticmethod
    def backward(ctx, dtoken):
        hs, hd, cs, cd = ctx.like
        dh = torch.empty(hs, dtype=hd, device=dtoken.device)
        dcond = torch.empty(cs, dtype=cd, device=dtoken.device)
        transfer([dh, dcond], ctx.dst, ctx.group)
        return _new_token(dtoken), None, None, None, dh, dcond


class _Recv(torch.autograd.Function):
    """Forward: (h, cond) of the previous stage (rank ``src``) received by
    this one (rank ``dst``) over their edge ``group``, and a token.
    Backward: their gradients sent back to the previous stage."""

    @staticmethod
    def forward(ctx, token, group, src, dst, h_like, cond_like):
        ctx.group, ctx.dst = group, dst
        h, cond = torch.empty_like(h_like), torch.empty_like(cond_like)
        transfer([h, cond], src, group)
        return h, cond, _new_token(token)

    @staticmethod
    def backward(ctx, dh, dcond, dtoken):
        transfer([dh.contiguous(), dcond.contiguous()], ctx.dst, ctx.group)
        return _new_token(dtoken), None, None, None, None, None


class _Deliver(torch.autograd.Function):
    """Forward: the last stage's output ``y`` (rank ``src``) broadcast over
    the pipe ``group`` to every stage (the others receive into a new
    tensor of ``shape``). Backward: the last stage's own gradient of it;
    the tokens' chains released."""

    @staticmethod
    def forward(ctx, y, shape, group, src, last, *tokens):
        ctx.last, ctx.n = last, len(tokens)
        out = y if last else torch.empty(shape, dtype=y.dtype, device=y.device)
        if group is not None:
            transfer([out], src, group)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, dy):
        tokens = [_new_token(dy)] * ctx.n
        return (dy if ctx.last else None), None, None, None, None, *tokens


class _GatherRows(torch.autograd.Function):
    """Forward: each data rank's rows of the output placed in -0.0 at
    ``rows`` of a (total, ...) buffer and summed over the data ``group``
    (exact). Backward: this rank's rows of the gradient (every rank
    computes the same loss from the whole output)."""

    @staticmethod
    def forward(ctx, y, group, rows, total):
        ctx.rows = rows
        out = torch.full((total, *y.shape[1:]), -0.0, dtype=y.dtype, device=y.device)
        out[rows] = y
        meshlib.all_reduce_sum([out], group)
        return out

    @staticmethod
    def backward(ctx, dy):
        return dy[ctx.rows], None, None, None


def pipelined_swinv2_forward(model, x: torch.Tensor, t, auxiliary: Optional[torch.Tensor] = None,
                             *, mesh: Optional[meshlib.Layout] = None, pipe_axis: str = "pipe",
                             n_micro: Optional[int] = None, data_axis: Optional[str] = None):
    """SwinV2 forward with the block-pair stack pipelined over the pipe axis
    of ``mesh`` (the rank layout; default ``mesh.layout()``).

    model: this rank's stage (``SwinV2(pipe_stages=S, pipe_stage=s)`` with
      the stage's weights). x: (B, H, W, in_channels); t: () or (B,);
      auxiliary: (B, aux_dim) or None. B must divide by ``n_micro``
      (default S), times the data size with ``data_axis``.

    Returns the (B, H, W, out_channels) fp32 output on every rank of the
    pipe group, equal to the one-process forward of each microbatch (the
    same kernels at the same shapes; the transfers are copies). A
    collective over the pipe group (and the data group with
    ``data_axis``): every rank of it calls it with the same shapes.
    """
    lay = mesh if mesh is not None else meshlib.layout()
    if pipe_axis != "pipe":
        raise ValueError(f"pipe_axis {pipe_axis!r}: the layout's axis is 'pipe'")
    if data_axis not in (None, "data"):
        raise ValueError(f"data_axis {data_axis!r}: None or 'data'")
    S, s = lay.pipe, lay.pipe_rank
    n_pairs = model.depth // 2
    if model.depth % 2 or n_pairs % S:
        raise ValueError(f"{n_pairs} block pairs do not split over {S} stages")
    M = S if n_micro is None else int(n_micro)
    if M < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    Dd = lay.data if data_axis else 1
    B = x.shape[0]
    if B % (M * Dd) != 0:
        raise ValueError(f"batch {B} does not split into {M} microbatches"
                         + (f" x {Dd} data shards" if Dd > 1 else ""))
    if (model.pipe_stages, model.pipe_stage) != (S, s):
        raise ValueError(f"the model is stage {model.pipe_stage} of {model.pipe_stages}; this "
                         f"rank is stage {s} of {S}")

    t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1)
    if t.shape[0] != B:
        t = t.expand(B)
    rows = slice(None)
    if Dd > 1:  # this data row's share of the global batch
        n = B // Dd
        rows = slice(lay.data_rank * n, (lay.data_rank + 1) * n)
        x, t = x[rows], t[rows]
        auxiliary = None if auxiliary is None else auxiliary[rows]
    mb = x.shape[0] // M
    gh, gw = model.grid_size
    h_like = torch.empty((mb, gh, gw, model.dim), dtype=model.dtype, device=x.device)
    cond_like = torch.empty((mb, model.dim), dtype=torch.float32, device=x.device)
    me = lay.data_rank * S + s  # rank = data index x S + stage
    grad = torch.is_grad_enabled()
    token = torch.empty(0, device=x.device, requires_grad=grad)
    send_token, recv_token = token, token
    received, ys = {}, []
    for k in range(M + S - 1):
        j = k - s  # the microbatch at this stage in tick k
        if 0 <= j < M:
            part = slice(j * mb, (j + 1) * mb)
            if s == 0:
                h, cond = model(x[part], t[part],
                                None if auxiliary is None else auxiliary[part], stage="embed")
            else:
                h, cond = received.pop(j)
            h = model(h, cond, stage="pairs")
            if s == S - 1:
                ys.append(model(h, cond, stage="head"))
        # the transfers of tick k, edge by edge: receive from s - 1, then send to s + 1
        if s > 0 and 0 <= k - (s - 1) < M:
            hr, cr, recv_token = _Recv.apply(recv_token, lay.prev_group, me - 1, me, h_like,
                                             cond_like)
            received[k - (s - 1)] = (hr, cr)
        if s < S - 1 and 0 <= j < M:
            send_token = _Send.apply(send_token, lay.next_group, me, me + 1, h, cond)

    last = s == S - 1
    shape = (x.shape[0], *model.img_resolution, model.out_channels)
    y = torch.cat(ys) if last else h_like.new_empty(0, dtype=torch.float32)
    y = _Deliver.apply(y, shape, lay.pipe_group if S > 1 else None, me - s + S - 1, last,
                       send_token, recv_token)
    if Dd > 1:
        y = _GatherRows.apply(y, lay.data_group, rows, B)
    return y
