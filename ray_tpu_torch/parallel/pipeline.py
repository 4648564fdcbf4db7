"""Pipeline parallelism over a ``torch.distributed`` group (port of
ray_tpu/parallel/pipeline.py).

The GPipe rotation of the reference, with rank = stage: rank i holds
stage i's parameters; microbatches enter at stage 0, activations hop to
the next rank each tick, and outputs drain from the last stage. Ticks =
n_micro + n_stages - 1; at tick t stage i works on microbatch t - i when
that lies in [0, n_micro), and idles otherwise (the reference computes
on zeros there and discards the result).

Layout, as the reference's: the microbatch stack is spread over the
ranks in a strided layout, rank d holding microbatches d, d + S,
d + 2S, ... as input, and it gets the same microbatches back as output.
At the start of each round of S ticks every rank sends stage 0 its
microbatch of the round (the reference's one all-gather a round), and
each drained output goes from the last stage straight to its home rank.
Every tick's sends and receives are posted together
(``dist.batch_isend_irecv``) on every rank and waited before the next
tick, so no rank waits on a message that is never sent.

torch's P2P calls carry no autograd, so the backward is written out:
the ticks run in reverse, each stage backpropagates its stage function
from the output grad its successor (or the output's home) sends back,
sends the input grad to its predecessor, and stage 0 returns each
microbatch's input grad to its home. ``remat=True`` wraps the stage
function in ``torch.utils.checkpoint``, so only each tick's input stays
alive between the passes.

Contract: ``fn(stage_params, x) -> y`` with y of x's shape and dtype.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.parallel import _group
from ray_tpu_torch.train.checkpoint import tree_map


def _tensors(tree: Any) -> List[torch.Tensor]:
    leaves: List[torch.Tensor] = []
    tree_map(lambda x: leaves.append(x) if isinstance(x, torch.Tensor)
             else None, tree)
    return leaves


def _with_tensors(tree: Any, tensors: List[torch.Tensor]) -> Any:
    """``tree`` with its tensors replaced, in order, by ``tensors``."""
    it = iter(tensors)
    return tree_map(lambda x: next(it) if isinstance(x, torch.Tensor)
                    else x, tree)


class _Schedule:
    """One rank's share of the rotation: R rounds of S ticks and S - 1
    drain ticks over n_micro = R S microbatches."""

    def __init__(self, group, stage: int, n_stages: int, rounds: int):
        self.group, self.stage, self.n = group, stage, n_stages
        self.n_micro = rounds * n_stages
        self.ticks = self.n_micro + n_stages - 1
        self.last = n_stages - 1

    def active(self, t: int, stage: int) -> bool:
        return 0 <= t - stage < self.n_micro

    def drained(self, t: int):
        """(home rank, slot) of the microbatch the last stage finishes at
        tick t, or None."""
        m = t - self.last
        if 0 <= m < self.n_micro:
            return m % self.n, m // self.n
        return None

    def exchange(self, sends, recvs) -> None:
        _group.Exchange(sends, recvs, self.group).wait()

    def gather_round(self, x_r: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Each rank's microbatch of the round, sent to stage 0 -> the S
        microbatches on stage 0 (in microbatch order), None elsewhere."""
        if self.stage:
            self.exchange([(x_r, 0)], [])
            return None
        bufs = [x_r] + [torch.empty_like(x_r) for _ in range(1, self.n)]
        self.exchange([], [(bufs[s], s) for s in range(1, self.n)])
        return bufs

    def scatter_round(self, grads: Optional[List[torch.Tensor]],
                      out: torch.Tensor) -> None:
        """The reverse of :meth:`gather_round`: stage 0 sends each
        microbatch's input grad home, where it lands in ``out``."""
        if self.stage:
            self.exchange([], [(out, 0)])
            return
        out.copy_(grads[0])
        self.exchange([(grads[s], s) for s in range(1, self.n)], [])


def _forward(body, params, xs: torch.Tensor, sched: _Schedule, keep: bool):
    """The forward ticks -> (this rank's outputs [R, mb, ...], the
    (tick, input, output) of each tick this stage worked, with the
    graph of ``body`` when ``keep``)."""
    stage, last = sched.stage, sched.last
    out_local = torch.zeros_like(xs)
    saved, state, round_buf = [], None, None
    for t in range(sched.ticks):
        if t < sched.n_micro and t % sched.n == 0:
            round_buf = sched.gather_round(xs[t // sched.n])
        out = None
        if sched.active(t, stage):
            inp = round_buf[t % sched.n] if stage == 0 else state
            if keep:
                inp = inp.detach().requires_grad_()
                with torch.enable_grad():
                    out = body(params, inp)
                saved.append((t, inp, out))
                out = out.detach()
            else:
                out = body(params, inp)
        sends, recvs, state = [], [], None
        if stage < last and sched.active(t, stage):
            sends.append((out, stage + 1))
        if stage > 0 and sched.active(t, stage - 1):
            state = torch.empty_like(xs[0])
            recvs.append((state, stage - 1))
        drained = sched.drained(t)
        if drained is not None:
            home, slot = drained
            if stage == last and home == last:
                out_local[slot] = out
            elif stage == last:
                sends.append((out, home))
            elif stage == home:
                recvs.append((out_local[slot], last))
        sched.exchange(sends, recvs)
    return out_local, saved


def _backward(saved, leaves: List[torch.Tensor], grad_out: torch.Tensor,
              sched: _Schedule):
    """The ticks in reverse -> (grad of this rank's inputs [R, mb, ...],
    the grad of each leaf, None where the leaf needs none)."""
    stage, last = sched.stage, sched.last
    by_tick = {t: (inp, out) for t, inp, out in saved}
    wanted = [leaf for leaf in leaves if leaf.requires_grad]
    d_wanted: List[Optional[torch.Tensor]] = [None] * len(wanted)
    d_xs = torch.empty_like(grad_out)
    d_send, d_round = None, [None] * sched.n
    for t in reversed(range(sched.ticks)):
        sends, recvs, d_out = [], [], None
        if stage > 0 and sched.active(t, stage - 1):
            sends.append((d_send, stage - 1))
        if stage < last and sched.active(t, stage):
            d_out = torch.empty_like(grad_out[0])
            recvs.append((d_out, stage + 1))
        drained = sched.drained(t)
        if drained is not None:
            home, slot = drained
            if stage == last and home == last:
                d_out = grad_out[slot]
            elif stage == last:
                d_out = torch.empty_like(grad_out[0])
                recvs.append((d_out, home))
            elif stage == home:
                sends.append((grad_out[slot], last))
        sched.exchange(sends, recvs)
        if sched.active(t, stage):
            inp, out = by_tick.pop(t)
            grads = torch.autograd.grad(out, [inp] + wanted, d_out,
                                        allow_unused=True)
            d_inp = (grads[0] if grads[0] is not None
                     else torch.zeros_like(inp))
            for i, g in enumerate(grads[1:]):
                if g is not None:
                    d_wanted[i] = g if d_wanted[i] is None \
                        else d_wanted[i] + g
            if stage == 0:
                d_round[t % sched.n] = d_inp
            else:
                d_send = d_inp
        if t < sched.n_micro and t % sched.n == 0:
            sched.scatter_round(d_round, d_xs[t // sched.n])
    it = iter(d_wanted)
    d_leaves = []
    for leaf in leaves:
        if not leaf.requires_grad:
            d_leaves.append(None)
            continue
        g = next(it)
        d_leaves.append(torch.zeros_like(leaf) if g is None else g)
    return d_xs, d_leaves


class _Pipeline(torch.autograd.Function):
    """The rotation with its written-out reverse schedule."""

    @staticmethod
    def forward(ctx, body, tree, sched, xs, *leaves):
        inner = [leaf.detach().requires_grad_(leaf.requires_grad)
                 for leaf in leaves]
        out, saved = _forward(body, _with_tensors(tree, inner), xs, sched,
                              keep=True)
        ctx.state = (saved, inner, sched)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        saved, inner, sched = ctx.state
        ctx.state = None
        d_xs, d_leaves = _backward(saved, inner, grad_out.contiguous(),
                                   sched)
        return (None, None, None, d_xs, *d_leaves)


def pipeline(fn: Callable[[Any, torch.Tensor], torch.Tensor],
             stage_params: Any, x: torch.Tensor, group=None, *,
             num_microbatches: int, remat: bool = False) -> torch.Tensor:
    """Run ``x`` through every stage of ``group`` (rank = stage).

    stage_params: this rank's stage parameters (the reference's stage
    axis, sliced); x: this rank's microbatches in the strided layout,
    [R * mb, ...] with R = num_microbatches / n_stages (microbatches
    d, d + S, ... on rank d, concatenated) -> the same microbatches'
    outputs. ``remat``: checkpoint the stage function, so the backward
    recomputes each stage's activations.
    """
    group, stage, n_stages = _group.resolve(group, x.device)
    batch = x.shape[0] * n_stages
    if batch % num_microbatches:
        raise ValueError(
            f"batch {batch} ({x.shape[0]} on each of {n_stages} stages) "
            f"not divisible by num_microbatches {num_microbatches}")
    if num_microbatches % n_stages:
        raise ValueError(
            f"num_microbatches {num_microbatches} not divisible by the "
            f"pipe size {n_stages} (required for the strided input "
            "sharding)")
    rounds = num_microbatches // n_stages
    xs = x.reshape(rounds, x.shape[0] // rounds, *x.shape[1:])
    sched = _Schedule(group, stage, n_stages, rounds)
    body = (functools.partial(checkpoint, fn, use_reentrant=False)
            if remat else fn)
    leaves = _tensors(stage_params)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            leaf.requires_grad for leaf in leaves)):
        out = _Pipeline.apply(body, stage_params, sched, xs, *leaves)
    else:
        out = _forward(body, stage_params, xs, sched, keep=False)[0]
    return out.reshape(x.shape)
