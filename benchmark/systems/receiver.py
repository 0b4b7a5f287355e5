"""The system under test for configurations that name `receiver`:
`sdr_tpu_torch.models.receiver.Receiver` built from the configuration's
`receiver` keyword arguments, one `Receiver.run` a step with its state
carried, and the program's host RDS decoders (`StreamingRdsDecoder` a
station on a live stream, `MultiStreamingRds` on a fleet, as the CLI's
`_run_stations`).

A system module gives `step_bytes(config, blocks_per_step)` and
`build(config, blocks_per_step, device)`, whose object has `step_bytes` (u8 bytes a station and step), `step(u8 (stations,
step_bytes)) -> {output: tensor}`, `free()` and `rds_decoders(stations,
live) -> (decoders, push)`.
"""

from __future__ import annotations


class ReceiverSystem:
    def __init__(self, config: dict, blocks_per_step: int, device):
        from sdr_tpu_torch.models.receiver import Receiver
        self.rx = Receiver(config["mode"], device=device,
                           **config["receiver"])
        self.bps, self.state = blocks_per_step, None
        self.step_bytes = self.rx.block_size_u8(blocks_per_step)

    def step(self, u8):
        out, self.state = self.rx.run(u8, blocks_per_step=self.bps,
                                      state=self.state)
        return out

    def free(self):
        self.state = self.rx = None

    def rds_decoders(self, stations: int, live: bool):
        """(decoders, push(soft (stations, n))): the program's decoders."""
        from sdr_tpu_torch.rds.streaming import (MultiStreamingRds,
                                                 StreamingRdsDecoder)
        sps = self.rx.cfg.rds_sps
        if live:
            decoders = [StreamingRdsDecoder(sps) for _ in range(stations)]

            def push(soft):
                for dec, row in zip(decoders, soft):
                    dec.push(row)
            return decoders, push
        multi = MultiStreamingRds(sps, stations)
        return multi.decoders, multi.push


def step_bytes(config: dict, blocks_per_step: int) -> int:
    """u8 bytes a station and step, without building on the device."""
    from sdr_tpu_torch.models.receiver import Receiver
    return Receiver(config["mode"], device="cpu", **config["receiver"]
                    ).block_size_u8(blocks_per_step)


def build(config: dict, blocks_per_step: int, device) -> ReceiverSystem:
    return ReceiverSystem(config, blocks_per_step, device)
