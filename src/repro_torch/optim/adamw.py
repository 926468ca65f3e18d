"""Minimal AdamW over parameter trees.  Port of ``src/repro/optim/adamw.py``.

f32 moments; bias correction from an int32 step counter with
``b1 ** step`` taken in float32, as the reference does; decoupled weight
decay, global-norm gradient clipping and a learning rate that is a number
or a schedule of the int32 step (``repro_torch.optim.schedules``).  The
update is functional: it returns new parameter and state trees and never
writes into its inputs, so trees that several clients share stay intact.

A state may also be *stacked*: every leaf carries a leading lane axis (one
lane per client of a cohort) and the step counter is a (G,) int32 vector.
``update`` then advances each lane by exactly the per-client update — the
reference's ``jax.vmap(opt.update)`` in the cohort server steps.  Under
that vmap each lane clips by its own gradient norm and reads the schedule
at its own step, and so does a stacked update here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, or (G,) int32 for a stacked state
    mu: PyTree
    nu: PyTree


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None

    def init(self, params: PyTree) -> AdamWState:
        leaf = tree_leaves(params)[0]
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=leaf.device),
                          mu=tree_map(z, params), nu=tree_map(z, params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate at a 0-d step, or one per lane of a (G,) step
        (each lane's schedule read at that lane's own step)."""
        if not callable(self.learning_rate):
            return torch.tensor(self.learning_rate, dtype=torch.float32, device=step.device)
        if step.dim() == 0:
            return self.learning_rate(step).float()
        return torch.stack([self.learning_rate(s).float() for s in step.unbind()])

    def _clip(self, grads: PyTree, stacked: bool) -> PyTree:
        """Scale the gradients to at most ``grad_clip_norm`` in global L2
        norm — per lane for a stacked state, over that lane's leaves only.
        Each lane sums its leaves' squares on its own, in the reference's
        order, so a lane equals the per-client update exactly."""
        leaves = tree_leaves(grads)
        if not stacked:
            scale = _clip_scale(self.grad_clip_norm, leaves)
            return tree_map(lambda g: g.float() * scale, grads)
        scale = torch.stack([_clip_scale(self.grad_clip_norm, [g[i] for g in leaves])
                             for i in range(leaves[0].shape[0])])
        return tree_map(lambda g: g.float() * _per_lane(scale, g), grads)

    def update(self, grads: PyTree, state: AdamWState, params: PyTree):
        """Returns (new_params, new_state)."""
        step = state.step + 1
        if self.grad_clip_norm is not None:
            grads = self._clip(grads, stacked=step.dim() > 0)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)
        stepf = step.float()
        f32 = dict(dtype=torch.float32, device=stepf.device)
        bc1 = _bias_correction(torch.tensor(b1, **f32), stepf)
        bc2 = _bias_correction(torch.tensor(b2, **f32), stepf)
        lr = self._lr(step)

        def upd(p, m, v):
            mhat = m / _per_lane(bc1, m)
            vhat = v / _per_lane(bc2, v)
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.float()
            return (p.float() - _per_lane(lr, p) * delta).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamWState(step=step, mu=mu, nu=nu)


def _clip_scale(clip_norm: float, leaves) -> torch.Tensor:
    """min(1, clip_norm / ||leaves||) with the reference's 1e-12 under the
    root, the squares summed leaf by leaf from Python's 0."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves) + 1e-12)
    return torch.clamp(clip_norm / gnorm, max=1.0)


def _bias_correction(beta: torch.Tensor, stepf: torch.Tensor) -> torch.Tensor:
    """1 - beta ** step, for a 0-d step or one per lane.  Each lane takes
    the 0-d power on its own: a vectorized pow may round differently from
    the scalar one, and a lane must equal the per-client update exactly."""
    if stepf.dim() == 0:
        return 1 - torch.pow(beta, stepf)
    return torch.stack([1 - torch.pow(beta, s) for s in stepf.unbind()])


def _per_lane(vec: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A (G,) lane vector shaped to broadcast over a (G, ...) leaf."""
    return vec if vec.dim() == 0 else vec.reshape(vec.shape + (1,) * (leaf.dim() - 1))
