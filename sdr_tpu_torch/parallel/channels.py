"""Channel data parallelism: independent FM stations split over a mesh.

Port of sdr_tpu/parallel/channels.py.  Every op of the port is
batch-polymorphic over leading axes, so channel DP needs no
communication: shard i takes rows [i*C/N, (i+1)*C/N) of the (C, n) batch
and steps them on its device.  The shards that share a device (a virtual
mesh) run as one batched `Receiver.run` over their rows; a shard on
another device steps a Receiver built there with the same arguments.
No shard reads another's tensors and no torch.distributed call runs; the
steps of the devices interleave, so that several cards work at once.
"""

from __future__ import annotations

import torch

from sdr_tpu_torch.io.stream import host_tensor, to_device
from sdr_tpu_torch.models.receiver import Receiver, concat_steps
from sdr_tpu_torch.parallel.mesh import Mesh, gather, receivers, tree_map


def sharded_run(rx: Receiver, iq_u8, mesh: Mesh, *, axis: str = "channels",
                blocks_per_step: int = 1):
    """Run the receiver over (channels, n) u8 with channels split on mesh.

    iq_u8: a (C, n) tensor or array, or this process's part of a batch
    across processes (distributed.make_global_batch), of which only the
    local rows run.  A channel count that the mesh does not divide is
    padded with silent channels (u8 128, which decodes to 0.0) and the
    padding sliced off the outputs and the final state.  Returns
    (outputs, final_state) as Receiver.run gives them, gathered on the
    mesh's first device.
    """
    from sdr_tpu_torch.parallel.distributed import GlobalBatch
    n_dev = mesh.shape[axis]
    if isinstance(iq_u8, GlobalBatch):
        if iq_u8.n_global % n_dev:
            raise ValueError(f"global batch of {iq_u8.n_global} channels "
                             f"not divisible by {n_dev}")
        return _run_shards(rx, host_tensor(iq_u8.local), mesh,
                           blocks_per_step)
    if mesh.process_count > 1:
        raise ValueError("a mesh across processes runs the batch of "
                         "distributed.make_global_batch")
    iq = host_tensor(iq_u8)
    n_ch = iq.shape[0]
    n_pad = (-n_ch) % n_dev
    if n_pad:
        iq = torch.cat([iq, torch.full((n_pad,) + iq.shape[1:], 128,
                                       dtype=iq.dtype, device=iq.device)])
    outs, final = _run_shards(rx, iq, mesh, blocks_per_step)
    if n_pad:
        outs = {k: v[:n_ch] for k, v in outs.items()}
        final = tree_map(lambda l: l[:n_ch] if l.ndim and
                         l.shape[0] == n_ch + n_pad else l, final)
    return outs, final


def _run_shards(rx: Receiver, iq: torch.Tensor, mesh: Mesh,
                blocks_per_step: int):
    """Step each device's shards of the (C, n) rows as one batch, the
    devices in turn each step, from cold states."""
    per = iq.shape[0] // len(mesh.devices)
    rxs = receivers(rx, mesh)
    runs, order = [], []
    for dev, shards in mesh.groups().items():
        rows = [r for s in shards for r in range(s * per, (s + 1) * per)]
        if rows == list(range(rows[0], rows[-1] + 1)):
            x = iq[rows[0]:rows[-1] + 1]
        else:
            x = iq[torch.as_tensor(rows, device=iq.device)]
        order += rows
        runs.append([rxs[dev], x, rxs[dev].init_state((len(rows),)), {}])
    for off, size in rx.spans(iq.shape[-1], blocks_per_step):
        for run in runs:
            r, x, state, chunks = run
            blk = to_device(x[..., off:off + size], r.device)
            run[2], out = r.step(state, blk)
            for k, v in out.items():
                chunks.setdefault(k, []).append(v)
    dev0 = mesh.devices[0]
    outs = [concat_steps(chunks, 1) for *_, chunks in runs]
    outputs = {k: gather([o[k] for o in outs], order, dev0) for k in outs[0]}
    final = tree_map(lambda *leaves: gather(list(leaves), order, dev0),
                     *(state for _, _, state, _ in runs))
    return outputs, final
