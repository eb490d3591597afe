"""Checkpoint and resume of the whole optimization state.

Counterpart of ``dnmf_tpu/utils/checkpoint.py``, over ``torch.save`` and
``torch.load(weights_only=True)`` instead of orbax: a checkpoint is one
file holding the :class:`~dnmf_tpu_torch.models.dnmf.DNMFState` tensors
(the factors and the Adam moments) and any extra tensors of the engine
(e.g. refined positions), saved from the host.  A state restores onto
whatever device the caller names, whatever device saved it.  The port
does not read orbax checkpoints: the JAX package's state crosses over as
NumPy (:func:`~dnmf_tpu_torch.models.dnmf.state_from_numpy`).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from dnmf_tpu_torch.models.dnmf import STATE_FIELDS, DNMFState


def save_state(path: str, state: DNMFState, **extra: torch.Tensor) -> None:
    """Write ``state`` and the ``extra`` tensors to ``path`` (overwriting;
    the file appears whole or not at all)."""
    payload = {name: getattr(state, name) for name in STATE_FIELDS}
    payload.update(extra)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({k: v.detach().cpu() for k, v in payload.items()}, tmp)
    os.replace(tmp, path)


def load_state(path: str, device) -> Tuple[DNMFState, Dict[str, torch.Tensor]]:
    """``(state, extra)`` of a checkpoint, every tensor on ``device``."""
    payload = torch.load(path, map_location=torch.device(device),
                         weights_only=True)
    state = DNMFState(**{name: payload.pop(name) for name in STATE_FIELDS})
    return state, payload
