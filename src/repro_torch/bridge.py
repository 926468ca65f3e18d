"""Move state between the JAX package and the port as numpy.

The JAX PRNG cannot be replayed in torch, so a parity run starts the port
from the reference's own initial state.  The caller turns the reference's
arrays into numpy (``jax.tree.map(np.asarray, tree)``); this module never
imports JAX.  Trees keep their key paths and dtypes (bfloat16 included,
bit for bit, beside the float32 leaves of a bf16 model): nested dicts of
arrays, stacked LoRA trees ``{"layers": {..., "a", "b"}}``, and optimizer
states with fields ``(step, mu, nu)``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState

PyTree = Any

_OPT_FIELDS = ("step", "mu", "nu")


def _is_opt_state(tree) -> bool:
    return tuple(getattr(tree, "_fields", ())) == _OPT_FIELDS


def to_torch(tree: PyTree, device) -> PyTree:
    """numpy tree -> torch tree on ``device`` (dtypes kept)."""
    if _is_opt_state(tree):
        return AdamWState(*(to_torch(getattr(tree, f), device) for f in _OPT_FIELDS))
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) has no torch counterpart to convert
        # from: the bits go across as int16 and are viewed as bfloat16
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def to_numpy(tree: PyTree) -> PyTree:
    """torch tree -> numpy tree (dtypes kept); optimizer states stay
    ``AdamWState`` with numpy leaves."""
    if isinstance(tree, AdamWState):
        return AdamWState(*(to_numpy(getattr(tree, f)) for f in _OPT_FIELDS))
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


PER_CLIENT_KEYS = ("client_params", "client_lora", "server_lora", "heads",
                   "client_opt", "server_opt")
# single trees: the frozen model and the standing global adapters and head
# (the event engine's async commits merge into the latter two)
SINGLE_KEYS = ("params", "_global_full", "_global_head")
STATE_KEYS = SINGLE_KEYS + PER_CLIENT_KEYS


def load_reference_state(sim, state: dict) -> None:
    """Overwrite a port ``Simulator``'s standing state with the reference
    Simulator's, given as numpy under :data:`STATE_KEYS`.  Per-client
    entries are lists in client order; every client gets its own tensors."""
    missing = [k for k in STATE_KEYS if k not in state]
    if missing:
        raise KeyError(f"reference state lacks {missing}")
    dev = sim.device
    for key in SINGLE_KEYS:
        setattr(sim, key, to_torch(state[key], dev))
    for key in PER_CLIENT_KEYS:
        vals = [to_torch(v, dev) for v in state[key]]
        if len(vals) != sim.u:
            raise ValueError(f"{key}: {len(vals)} entries for {sim.u} clients")
        setattr(sim, key, vals)


TRAINER_KEYS = ("params", "global_full", "global_head")


def load_reference_trainer_state(trainer, state: dict) -> None:
    """Overwrite a port ``PopulationTrainer``'s initial state with the
    reference trainer's, given as numpy under :data:`TRAINER_KEYS`: the
    frozen params and the standing global adapters and head (the store's
    ``global_full`` / ``global_head``, from which every slot
    materializes).  Call it before the run, while no slot exists."""
    missing = [k for k in TRAINER_KEYS if k not in state]
    if missing:
        raise KeyError(f"reference state lacks {missing}")
    if trainer.store.touched() or trainer._client_params:
        raise ValueError("load the reference state before any slot materializes")
    dev = trainer.device
    trainer.params = to_torch(state["params"], dev)
    trainer.store.reset_global(to_torch(state["global_full"], dev),
                               to_torch(state["global_head"], dev))
