"""Several recordings demixed together (one state per recording).

Counterpart of ``dnmf_tpu/parallel/batched.py``.  The JAX package stacks
the recordings' states along a leading axis and ``vmap``s the round, and
``pallas_call``'s batching rule prepends the recordings axis to each
kernel's grid.  Here the states stack the same way (:func:`stack_states`)
and :func:`batched_round` runs the round's functions on the stacked state
(:mod:`dnmf_tpu_torch.models.dnmf`): per frame block, one launch of the
motion kernel A and one of the Gram kernel C (exact Grams) or of the c1
kernel B (closed-form Grams) covers every recording's frames, each
recording with its own neuron table (built in one launch per pass); one
Adam step, one corner-regularizer call, the closed form and the trace
updates take the recordings as a leading batch axis.  No Python loop
runs over the recordings (the models that no kernel computes excepted:
they take the footprint ops recording by recording).  On a mesh with a
``batch`` axis the recordings split over it: each rank runs its own run
of them so, and one ``all_gather`` over the axis gives every rank all
the results.  The round (a rank's, on a mesh) is one captured CUDA graph
on the card (:func:`dnmf_tpu_torch.models.graphs.batched_round`), the
``all_gather`` running after its replay.  All recordings share (size, K,
T).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dnmf_tpu_torch.config import ModelConfig
from dnmf_tpu_torch.models import dnmf as model_lib
from dnmf_tpu_torch.models import graphs
from dnmf_tpu_torch.parallel.mesh import (BATCH_AXIS, all_gather, axis_index,
                                          axis_size)


def stack_states(states) -> model_lib.DNMFState:
    """Per-recording states stacked into one state with a leading
    recordings axis on every field; ``ValueError`` unless every field has
    one shape in all of them (equal size, K and T)."""
    for name in model_lib.STATE_FIELDS:
        shapes = {tuple(getattr(s, name).shape) for s in states}
        if len(shapes) > 1:
            raise ValueError(f"a recordings axis needs equal shapes in every "
                             f"recording: {name} has {sorted(shapes)}")
    return model_lib.DNMFState(**{
        name: torch.stack([getattr(s, name) for s in states])
        for name in model_lib.STATE_FIELDS})


def unstack_states(batched: model_lib.DNMFState):
    """A stacked state split back into per-recording states."""
    return [model_lib.DNMFState(**{name: getattr(batched, name)[i]
                                   for name in model_lib.STATE_FIELDS})
            for i in range(batched.beta.shape[0])]


def batched_round(states: model_lib.DNMFState, videos: torch.Tensor,
                  model: ModelConfig, optimizer: model_lib.Adam, gamma: float,
                  mu_iters: int, mu_gamma: float = 0.0, frame_block: int = 8,
                  use_kernels: bool = False, gram_mode: str = "exact",
                  gram_window=None, mesh=None
                  ) -> Tuple[model_lib.DNMFState, dict]:
    """One alternation round (a motion epoch, the Grams, ``mu_iters``
    trace updates) of every recording.

    Args:
      states: stacked state (leading recordings axis on every field).
      videos: ``[R, T, P]`` flattened frames.
      mesh: with a ``batch`` axis of ``nb`` ranks, ``R / nb`` recordings
        per rank, the results gathered on every rank.  The round (of the
        rank's recordings) is :func:`dnmf_tpu_torch.models.graphs.
        batched_round`: with the kernels one captured graph (the JAX
        package's ``jit`` of the ``vmap``-ed round), else eager.

    Returns:
      The stacked updated states and the per-recording metrics ``[R]``.
    """
    kw = dict(mu_gamma=mu_gamma, frame_block=frame_block,
              use_kernels=use_kernels, gram_mode=gram_mode,
              gram_window=gram_window)
    if mesh is None:
        return graphs.batched_round(states, videos, model, optimizer, gamma,
                                    mu_iters, **kw)
    r = videos.shape[0]
    nb, ib = axis_size(mesh, BATCH_AXIS), axis_index(mesh, BATCH_AXIS)
    if r % nb:
        raise ValueError(f"{r} recordings must divide evenly over mesh "
                         f"batch={nb}")
    per = r // nb
    mine = slice(ib * per, (ib + 1) * per)
    state = model_lib.DNMFState(**{name: getattr(states, name)[mine]
                                   for name in model_lib.STATE_FIELDS})
    local, metrics = graphs.batched_round(state, videos[mine], model,
                                          optimizer, gamma, mu_iters, **kw)
    if nb > 1:
        local = model_lib.DNMFState(**{
            name: torch.cat(all_gather(getattr(local, name), mesh,
                                       BATCH_AXIS))
            for name in model_lib.STATE_FIELDS})
        metrics = {k: torch.cat(all_gather(v, mesh, BATCH_AXIS))
                   for k, v in metrics.items()}
    return local, metrics
