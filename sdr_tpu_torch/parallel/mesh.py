"""Device meshes for the parallel layer.

Port of sdr_tpu/parallel/mesh.py.  The reference's scale-out (SURVEY
§2.3) maps onto torch as
  - channel data parallelism: independent RF stations split over the
    shards of a mesh (parallel/channels.py),
  - time-axis sequence parallelism: one station's sample stream split
    over shards with overlap halos (parallel/timeshard.py),
  - one antenna's wideband stream fanned out to station slices
    (parallel/wideband.py),
  - several processes, each feeding its own shard (parallel/distributed.py).

A `Mesh` is an ordered tuple of torch devices with one axis name: shard i
runs on devices[i].  A device may repeat.  `make_mesh(devices=[torch.device(
"cuda")] * 8)` is a *virtual* mesh of 8 shards on one card, the
counterpart of the reference's 8 virtual CPU devices (tests/conftest.py);
the shards that share a device run as one batch there.  The reference's
`channel_sharding` and `replicated` return jax NamedShardings, which have
no torch object behind them: the parallel functions place each shard
themselves, so they are left out.
"""

from __future__ import annotations

import dataclasses

import torch


def canonical(device: torch.device | str) -> torch.device:
    """`device` with its index filled in: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One mesh axis over `devices` (this process's shards, in order).

    Across processes (parallel/distributed.py) every process holds a mesh
    of its own devices, `process_count` of them in all; `shape` is then
    the global shard count, as the reference's global mesh has it."""
    devices: tuple[torch.device, ...]
    axis: str = "channels"
    process_index: int = 0
    process_count: int = 1

    @property
    def shape(self) -> dict[str, int]:
        """{axis: shards}, as jax.sharding.Mesh.shape."""
        return {self.axis: len(self.devices) * self.process_count}

    def groups(self) -> dict[torch.device, list[int]]:
        """The local shards on each distinct device, in order of first
        appearance: {device: [shard, ...]}."""
        out: dict[torch.device, list[int]] = {}
        for i, d in enumerate(self.devices):
            out.setdefault(d, []).append(i)
        return out


def receivers(rx, mesh: Mesh) -> dict:
    """{device: Receiver} for each distinct device of the mesh: `rx` on
    its own device, elsewhere one built with its arguments."""
    here = canonical(rx.device)
    return {d: rx if d == here else rx.on(d) for d in mesh.groups()}


def tree_map(fn, *trees):
    """fn over the leaves of equal trees of NamedTuples, tuples and dicts
    (None stays None): a receiver state, a channelizer state."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple):
        vals = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
    return fn(*trees)


def gather(parts: list[torch.Tensor], order: list[int],
           device: torch.device) -> torch.Tensor:
    """Concatenate the row blocks `parts` on `device` and put the rows in
    shard order: `order` lists the global row of each concatenated row."""
    x = (parts[0].to(device) if len(parts) == 1
         else torch.cat([p.to(device) for p in parts]))
    if order != sorted(order):
        x = x[torch.as_tensor(order, device=device).argsort()]
    return x


def make_mesh(n_devices: int | None = None, axis: str = "channels",
              devices: list | None = None) -> Mesh:
    """1-D mesh over the given axis (default: every CUDA device here).

    Raises where no CUDA device is found: a CPU mesh is asked for by name
    (`devices=[torch.device("cpu")] * n`), never made in its place."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "for a mesh elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(tuple(canonical(d) for d in devices), axis)
