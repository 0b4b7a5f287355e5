"""The system under test for configurations that name `wideband`: the
CLI's `--wideband` path, `sdr_tpu_torch.models.wideband.WidebandReceiver`
over a `WidebandChannelizer` of the antenna's offsets (the CUDA engine on
the card, the plain `mfb` engine elsewhere, as the CLI chooses) and a
`Receiver` of the configuration's `receiver` keyword arguments, one
`WidebandReceiver.step` a step with its state carried, and the program's
host RDS decoders.

It takes the antenna layout (harness.py): `step_bytes(config,
blocks_per_step, antenna=)` counts the stream's u8 bytes a step, and the
object's `step(u8 (1, step_bytes))` returns the K stations' outputs.
"""

from __future__ import annotations

import torch


def _receiver(config: dict, device):
    from sdr_tpu_torch.models.receiver import Receiver
    return Receiver(config["mode"], device=device, **config["receiver"])


class WidebandSystem:
    def __init__(self, config: dict, blocks_per_step: int, device,
                 antenna: dict):
        from sdr_tpu_torch.models.wideband import WidebandReceiver
        from sdr_tpu_torch.ops.channelizer import WidebandChannelizer
        device = torch.device(device)
        rx = _receiver(config, device)
        chan = WidebandChannelizer(
            antenna["fs"], rx.cfg.rf_fs, antenna["offsets_hz"],
            engine="pallas" if device.type == "cuda" else "mfb",
            device=device, **config["channelizer"])
        self.wrx = WidebandReceiver(chan, rx)
        self.state = self.wrx.init_state()
        self.step_bytes = self.wrx.block_wide(blocks_per_step)

    def step(self, u8):
        self.state, out = self.wrx.step(
            self.state, u8.reshape(-1).to(self.wrx.device))
        return out

    def free(self):
        self.state = self.wrx = None

    def rds_decoders(self, stations: int, live: bool):
        """(decoders, push(soft (stations, n))): the program's decoders."""
        from sdr_tpu_torch.rds.streaming import (MultiStreamingRds,
                                                 StreamingRdsDecoder)
        sps = self.wrx.rx.cfg.rds_sps
        if live:
            decoders = [StreamingRdsDecoder(sps) for _ in range(stations)]

            def push(soft):
                for dec, row in zip(decoders, soft):
                    dec.push(row)
            return decoders, push
        multi = MultiStreamingRds(sps, stations)
        return multi.decoders, multi.push


def step_bytes(config: dict, blocks_per_step: int, antenna: dict) -> int:
    """The stream's u8 bytes a step, without building on the device: a
    station's step at the RF rate times the channelizer's decimation."""
    rx = _receiver(config, "cpu")
    return rx.block_size_u8(blocks_per_step) * (int(antenna["fs"])
                                                // rx.cfg.rf_fs)


def build(config: dict, blocks_per_step: int, device,
          antenna: dict) -> WidebandSystem:
    return WidebandSystem(config, blocks_per_step, device, antenna)
