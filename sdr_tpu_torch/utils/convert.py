"""Carry a receiver state across between sdr_tpu and this port.

`state_from_numpy` takes the reference's ReceiverState with numpy leaves
(`jax.tree.map(np.asarray, state)`) and returns the port's state on a
device; `state_to_numpy` goes the other way.  Every leaf keeps its shape
and dtype, bf16 leaves included (numpy holds those as ml_dtypes.bfloat16,
which torch cannot wrap, so they cross as their 16-bit patterns).  Only
the ported parts of the state cross: stereo and RDS must be None.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.models.state import FrontEndState, MonoState, ReceiverState


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.array(a)  # an owned, C-ordered copy; keeps 0-d leaves 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, shipped with jax
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def state_from_numpy(tree, device: torch.device | str = "cpu"
                     ) -> ReceiverState:
    """Reference ReceiverState (numpy leaves) -> the port's ReceiverState."""
    if tree.stereo is not None or tree.rds is not None:
        raise NotImplementedError("only the mono state is ported "
                                  "(ROADMAP.md queue A item 7)")
    front = FrontEndState(*(_leaf_to_torch(getattr(tree.front, f), device)
                            for f in FrontEndState._fields))
    mono = MonoState(*(_leaf_to_torch(getattr(tree.mono, f), device)
                       for f in MonoState._fields))
    return ReceiverState(front=front, mono=mono)


def state_to_numpy(state: ReceiverState) -> ReceiverState:
    """The port's ReceiverState -> the same NamedTuples with numpy leaves,
    ready for `jax.tree.map(jnp.asarray, ...)` on the reference's side."""
    return ReceiverState(
        front=FrontEndState(*map(_leaf_to_numpy, state.front)),
        mono=MonoState(*map(_leaf_to_numpy, state.mono)))
