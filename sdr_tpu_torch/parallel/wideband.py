"""Station-sharded wideband receiver: one antenna stream -> K stations
over an N-shard mesh.

Port of sdr_tpu/parallel/wideband.py.  The raw wideband block is the one
physical input: it goes once to each distinct device of the mesh.  Each
device channelizes only its shards' stations (the modulated filter
bank's constants are per station, so splitting the station axis splits
the bank): the shards that share a device run as one channelizer over
their station slices, in shard order, which launches the channelizer
kernel (csrc/channelizer.cu) once a step, and one batched receiver, as
channel DP batches them (parallel/channels.py).  Where one device holds
every shard (a virtual mesh), its channelizer is `chan` itself, so the
run is the serial WidebandReceiver.run's.  No shard reads another's
tensors and no torch.distributed call runs.

The reference's `interpret` (Pallas interpret mode) is accepted and has
no effect; its `last_hlo` (the compiled per-device program, whose
collectives its test counts) has no meaning here and is left out:
tests/test_torch_parallel.py checks instead that the run passes with
every torch.distributed collective made to raise.
"""

from __future__ import annotations

import torch

from sdr_tpu_torch.io.stream import host_tensor, to_device
from sdr_tpu_torch.models.receiver import Receiver, concat_steps
from sdr_tpu_torch.ops.channelizer import WidebandChannelizer
from sdr_tpu_torch.parallel.mesh import (Mesh, canonical, gather, receivers,
                                         tree_map)


def _dtype_name(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def sharded_wideband_run(chan: WidebandChannelizer, rx: Receiver,
                         wide, mesh: Mesh, *, axis: str = "stations",
                         blocks_per_step: int = 1,
                         interpret: bool | None = None):
    """Run the wideband receiver with stations split over `mesh`.

    chan: a WidebandChannelizer(engine="pallas") for all K stations (K
      divisible by the mesh's shard count, each slice a multiple of 8).
    rx:   the per-station Receiver (the same program runs on every shard).
    wide: (n,) raw interleaved stream, u8 or f32: the one antenna input.
    interpret: a TPU-lowering knob, accepted and of no effect.

    Returns (outputs (K, ...) over time, final receiver state), as the
    serial WidebandReceiver.run gives them, gathered on the mesh's first
    device.
    """
    if chan.engine != "pallas":
        raise ValueError("station sharding uses the pallas engine")
    if mesh.process_count > 1:
        raise ValueError("station sharding runs within one process")
    n_dev = mesh.shape[axis]
    k = chan.k
    if k % n_dev:
        raise ValueError(f"{k} stations not divisible by {n_dev} shards")
    kl = k // n_dev
    if kl % 8:
        raise ValueError(f"{kl} stations a shard: each slice must be a "
                         "multiple of 8")
    pl = chan._pl
    bw = 2 * (rx.block_size_u8(blocks_per_step) // 2) * chan.decim
    nsteps = wide.shape[-1] // bw
    if nsteps == 0:
        raise ValueError(f"capture shorter than one wideband block ({bw})")
    steps = host_tensor(wide[: nsteps * bw]).reshape(nsteps, bw)
    rxs = receivers(rx, mesh)
    runs, order = [], []
    for dev, shards in mesh.groups().items():
        rows = [r for s in shards for r in range(s * kl, (s + 1) * kl)]
        if len(shards) == n_dev and canonical(chan.device) == dev:
            sub = chan
        else:
            sub = WidebandChannelizer(
                chan.fs_wide, chan.fs_out, [chan.freqs[r] for r in rows],
                cutoff=chan.cutoff, taps=chan.taps, engine="pallas",
                ingest=pl.ingest, tile=pl.tile,
                compute_dtype=_dtype_name(chan.compute_dtype),
                out_dtype=_dtype_name(pl.out_dtype), device=dev)
        order += rows
        runs.append([sub, rxs[dev], to_device(steps, dev), sub.init_state(),
                     rxs[dev].init_state((len(rows),)), {}])
    for s in range(nsteps):
        for run in runs:
            sub, r, x, cstate, rstate, chunks = run
            (i_st, q_st), run[3] = sub.call_interleaved(x[s], cstate)
            run[4], out = r.step_iq(rstate, i_st, q_st)
            for key, v in out.items():
                chunks.setdefault(key, []).append(v)
    dev0 = mesh.devices[0]
    outs = [concat_steps(run[5], 1) for run in runs]
    outputs = {key: gather([o[key] for o in outs], order, dev0)
               for key in outs[0]}
    final = tree_map(lambda *leaves: gather(list(leaves), order, dev0),
                     *(run[4] for run in runs))
    return outputs, final
