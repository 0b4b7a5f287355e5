"""Wideband streaming receiver: channelize + decode K stations.

Port of sdr_tpu/models/wideband.py.  One antenna stream at the wideband
rate goes through the channelizer (ops/channelizer.py) and the K station
basebands through the port's Receiver (batch axis = stations): `step` is
the composition of the two, and the channelizer's oscillator and tail
state ride beside the receiver's state.  PyTorch runs eagerly, so where
the reference scans `scan_steps` blocks per dispatch, `run` and `stream`
are Python loops over steps; `stream` keeps the reference's re-framing,
so captures larger than RAM stream block by block from disk or stdin.

Input is the raw interleaved wideband stream in f32 or u8 (reference
ingest semantics, (x-128)/128 -- src/iofunc.cpp:62-69); the mfb and
pallas engines decode u8 inside their product.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from sdr_tpu_torch.io.logger import stage_scope as scope
from sdr_tpu_torch.io.stream import decode_u8_iq, to_device
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.ops.channelizer import WidebandChannelizer


class WidebandReceiver:
    """Wideband block -> K station outputs.

    Args:
      chan: configured WidebandChannelizer (K stations).
      rx: per-station Receiver (batch axis = stations), on chan's device;
        the wideband receiver runs where they do (`device`).
    """

    def __init__(self, chan: WidebandChannelizer, rx: Receiver):
        if chan.device != rx.device:
            raise ValueError(f"channelizer on {chan.device}, receiver on "
                             f"{rx.device}: they must share a device")
        self.chan = chan
        self.rx = rx
        self.device = rx.device
        # wideband samples per receiver block: station block in IQ pairs
        # times the channelizer decimation
        self.block_pairs = (rx.block_size_u8() // 2) * chan.decim

    def block_wide(self, blocks_per_step: int = 1) -> int:
        """Interleaved wideband scalars (2 per IQ pair) per step."""
        return 2 * self.block_pairs * blocks_per_step

    def init_state(self):
        return (self.chan.init_state(), self.rx.init_state((self.chan.k,)))

    def step(self, state, wide: torch.Tensor):
        """One block: `wide` is the raw interleaved stream (2N,), u8 or f32,
        on the device.  Returns (new_state, outputs) with outputs batched
        over stations."""
        cstate, rstate = state
        with scope("channelize"):
            if self.chan.engine in ("mfb", "pallas"):
                (i_st, q_st), cstate = self.chan.call_interleaved(wide,
                                                                  cstate)
            else:
                with scope("wideband_ingest"):
                    if wide.dtype == torch.uint8:
                        i_w, q_w = decode_u8_iq(wide)
                    else:
                        i_w, q_w = wide[0::2], wide[1::2]
                (i_st, q_st), cstate = self.chan(i_w, q_w, cstate)
        rstate, out = self.rx.step_iq(rstate, i_st, q_st)
        return (cstate, rstate), out

    def _steps(self, state, steps: torch.Tensor):
        """Step over the rows of steps (S, block) on the device; returns
        (state, outputs concatenated over time: (K, S*n) streams and
        (K, S) per-step scalars)."""
        chunks: dict[str, list[torch.Tensor]] = {}
        for wide in steps:
            state, out = self.step(state, wide)
            for k, v in out.items():
                chunks.setdefault(k, []).append(v)
        return state, {k: torch.cat(vs, dim=-1) if vs[0].ndim == 2
                       else torch.stack(vs, dim=-1)
                       for k, vs in chunks.items()}

    def run(self, wide, *, blocks_per_step: int = 1, state=None):
        """Whole capture: step over all full blocks.

        wide: (n,) interleaved u8 or f32 (numpy or tensor); a trailing
        partial block is dropped.  Returns (outputs concatenated over
        time, final_state).
        """
        bw = self.block_wide(blocks_per_step)
        nsteps = wide.shape[-1] // bw
        if nsteps == 0:
            raise ValueError(f"capture shorter than one block ({bw})")
        steps = to_device(wide[: nsteps * bw], self.device).reshape(
            nsteps, bw)
        if state is None:
            state = self.init_state()
        state, outputs = self._steps(state, steps)
        return outputs, state

    def stream(self, reader: Iterable[np.ndarray], *,
               blocks_per_step: int = 1, state=None,
               scan_steps: int = 4) -> Iterator[tuple[dict, tuple]]:
        """Stream from a chunk reader: yields (outputs, state) per chunk.

        reader: iterable of numpy arrays (any sizes), re-framed into
        `scan_steps` blocks per chunk with a bounded carry, so captures
        larger than RAM stream in O(scan_steps * block) memory; the whole
        blocks left at the end are stepped one at a time.
        """
        if state is None:
            state = self.init_state()
        bw = self.block_wide(blocks_per_step)
        chunk = scan_steps * bw
        buf: list[np.ndarray] = []
        have = 0
        for raw in reader:
            buf.append(np.asarray(raw))
            have += len(buf[-1])
            while have >= chunk:
                flat = np.concatenate(buf) if len(buf) > 1 else buf[0]
                steps, rest = flat[:chunk], flat[chunk:]
                buf, have = [rest], len(rest)
                state, outputs = self._steps(
                    state, to_device(steps, self.device).reshape(
                        scan_steps, bw))
                yield outputs, state
        # tail: whole blocks that don't fill a chunk, one at a time
        flat = np.concatenate(buf) if len(buf) > 1 else (
            buf[0] if buf else np.zeros(0))
        for b in range(len(flat) // bw):
            state, out = self.step(
                state, to_device(flat[b * bw:(b + 1) * bw], self.device))
            yield out, state
