"""Minimal AdamW over parameter trees.  Port of ``src/repro/optim/adamw.py``.

f32 moments; bias correction from an int32 step counter with
``b1 ** step`` taken in float32, as the reference does.  The update is
functional: it returns new parameter and state trees and never writes into
its inputs, so trees that several clients share stay intact.

A state may also be *stacked*: every leaf carries a leading lane axis (one
lane per client of a cohort) and the step counter is a (G,) int32 vector.
``update`` then advances each lane by exactly the per-client update — the
reference's ``jax.vmap(opt.update)`` in the ragged cohort server step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, or (G,) int32 for a stacked state
    mu: PyTree
    nu: PyTree


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float = 1e-5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def __post_init__(self):
        if callable(self.learning_rate):
            raise NotImplementedError("learning-rate schedules come with the "
                                      "launch slice (ROADMAP Queue A, item 11)")

    def init(self, params: PyTree) -> AdamWState:
        leaf = tree_leaves(params)[0]
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=leaf.device),
                          mu=tree_map(z, params), nu=tree_map(z, params))

    def update(self, grads: PyTree, state: AdamWState, params: PyTree):
        """Returns (new_params, new_state)."""
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)
        stepf = step.float()
        f32 = dict(dtype=torch.float32, device=stepf.device)
        bc1 = _bias_correction(torch.tensor(b1, **f32), stepf)
        bc2 = _bias_correction(torch.tensor(b2, **f32), stepf)
        lr = torch.tensor(self.learning_rate, **f32)

        def upd(p, m, v):
            mhat = m / _per_lane(bc1, m)
            vhat = v / _per_lane(bc2, v)
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            return (p.float() - lr * delta).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamWState(step=step, mu=mu, nu=nu)



def _bias_correction(beta: torch.Tensor, stepf: torch.Tensor) -> torch.Tensor:
    """1 - beta ** step, for a 0-d step or one per lane.  Each lane takes
    the 0-d power on its own: a vectorized pow may round differently from
    the scalar one, and a lane must equal the per-client update exactly."""
    if stepf.dim() == 0:
        return 1 - torch.pow(beta, stepf)
    return torch.stack([1 - torch.pow(beta, s) for s in stepf.unbind()])


def _per_lane(bc: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A (G,) lane vector shaped to broadcast over a (G, ...) leaf."""
    return bc if bc.dim() == 0 else bc.reshape(bc.shape + (1,) * (leaf.dim() - 1))
