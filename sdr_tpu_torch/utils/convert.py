"""Carry a receiver state across between sdr_tpu and this port.

`state_from_numpy` takes the reference's ReceiverState with numpy leaves
(`jax.tree.map(np.asarray, state)`) and returns the port's state on a
device; `state_to_numpy` goes the other way.  Every leaf keeps its shape
and dtype, bf16 leaves included (numpy holds those as ml_dtypes.bfloat16,
which torch cannot wrap, so they cross as their 16-bit patterns).  The
stereo and RDS states and their carrier (PLL) states cross too; a slot
that is None stays None.  `chan_state_from_numpy` / `chan_state_to_numpy`
carry a WidebandChannelizer state (a dict of leaves, for every engine:
the u8 tail of the pallas engine included), and `wideband_state_*` the
(channelizer, receiver) state pair of WidebandReceiver.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.models.state import (FrontEndState, MonoState, RdsState,
                                        ReceiverState, StereoState)
from sdr_tpu_torch.ops.pll import PLLState


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


# the port's NamedTuple for each field of the tree that is itself a tuple
_NESTED = {"front": FrontEndState, "mono": MonoState, "stereo": StereoState,
           "rds": RdsState, "pll": PLLState}


def _convert(node, cls, leaf):
    """Rebuild `node` (any NamedTuple with cls's fields) as cls, converting
    its leaves with `leaf` and its nested tuples by field name."""
    if node is None:
        return None
    return cls(*(_convert(getattr(node, f), _NESTED[f], leaf)
                 if f in _NESTED else leaf(getattr(node, f))
                 for f in cls._fields))


def state_from_numpy(tree, device: torch.device | str = "cuda"
                     ) -> ReceiverState:
    """Reference ReceiverState (numpy leaves) -> the port's ReceiverState."""
    return _convert(tree, ReceiverState,
                    lambda a: _leaf_to_torch(a, device))


def state_to_numpy(state: ReceiverState) -> ReceiverState:
    """The port's ReceiverState -> the same NamedTuples with numpy leaves,
    ready for `jax.tree.map(jnp.asarray, ...)` on the reference's side
    once rebuilt as its types (field for field)."""
    return _convert(state, ReceiverState, _leaf_to_numpy)


def chan_state_from_numpy(state: dict, device: torch.device | str = "cuda"
                          ) -> dict[str, torch.Tensor]:
    """Reference channelizer state (dict of numpy leaves) -> the port's."""
    return {k: _leaf_to_torch(v, device) for k, v in state.items()}


def chan_state_to_numpy(state: dict[str, torch.Tensor]) -> dict:
    return {k: _leaf_to_numpy(v) for k, v in state.items()}


def wideband_state_from_numpy(state, device: torch.device | str = "cuda"):
    """Reference WidebandReceiver state (channelizer dict, ReceiverState)
    with numpy leaves -> the port's pair."""
    cstate, rstate = state
    return (chan_state_from_numpy(cstate, device),
            state_from_numpy(rstate, device))


def wideband_state_to_numpy(state):
    cstate, rstate = state
    return chan_state_to_numpy(cstate), state_to_numpy(rstate)
