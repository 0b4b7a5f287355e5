"""Station-sharded wideband receiver: one antenna stream -> K stations
over an N-shard mesh.

Port of sdr_tpu/parallel/wideband.py.  The raw wideband block is the one
physical input: it goes once to each distinct device of the mesh.  Each
shard channelizes only its slice of the stations (the modulated filter
bank's constants are per station, so splitting the station axis splits
the bank) with a channelizer of its own, which launches the channelizer
kernel (csrc/channelizer.cu) on its kl = K/N stations, and runs the
per-station receiver on them as ordinary channel DP.  No shard reads
another's tensors and no torch.distributed call runs.

The reference's `interpret` (Pallas interpret mode) and `last_hlo` (the
compiled per-device program, whose collectives its test counts) have no
meaning here and are left out; tests/test_torch_parallel.py checks
instead that the run passes with every torch.distributed collective made
to raise.
"""

from __future__ import annotations

import torch

from sdr_tpu_torch.models.receiver import Receiver, concat_steps
from sdr_tpu_torch.ops.channelizer import WidebandChannelizer
from sdr_tpu_torch.parallel.channels import as_tensor
from sdr_tpu_torch.parallel.mesh import Mesh, receivers, tree_map


def _dtype_name(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def sharded_wideband_run(chan: WidebandChannelizer, rx: Receiver,
                         wide, mesh: Mesh, *, axis: str = "stations",
                         blocks_per_step: int = 1):
    """Run the wideband receiver with stations split over `mesh`.

    chan: a WidebandChannelizer(engine="pallas") for all K stations (K
      divisible by the mesh's shard count, each slice a multiple of 8).
    rx:   the per-station Receiver (the same program runs on every shard).
    wide: (n,) raw interleaved stream, u8 or f32: the one antenna input.

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
    steps = as_tensor(wide[: nsteps * bw]).reshape(nsteps, bw)
    inputs = {dev: steps.to(dev) for dev in mesh.groups()}
    rxs = receivers(rx, mesh)
    shards = []
    for d, dev in enumerate(mesh.devices):
        sub = WidebandChannelizer(
            chan.fs_wide, chan.fs_out, list(chan.freqs[d * kl:(d + 1) * kl]),
            cutoff=chan.cutoff, taps=chan.taps, engine="pallas",
            ingest=pl.ingest, tile=pl.tile,
            compute_dtype=_dtype_name(chan.compute_dtype),
            out_dtype=_dtype_name(pl.out_dtype), device=dev)
        shards.append([sub, rxs[dev], inputs[dev], sub.init_state(),
                       rxs[dev].init_state((kl,)), {}])
    for s in range(nsteps):
        for shard in shards:
            sub, r, x, cstate, rstate, chunks = shard
            (i_st, q_st), shard[3] = sub.call_interleaved(x[s], cstate)
            shard[4], out = r.step_iq(rstate, i_st, q_st)
            for key, v in out.items():
                chunks.setdefault(key, []).append(v)
    dev0 = mesh.devices[0]
    outs = [concat_steps(shard[5], 1) for shard in shards]
    outputs = {key: torch.cat([o[key].to(dev0) for o in outs])
               for key in outs[0]}
    final = tree_map(lambda *leaves: torch.cat([l.to(dev0) for l in leaves]),
                     *(shard[4] for shard in shards))
    return outputs, final
