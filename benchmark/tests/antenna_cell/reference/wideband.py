"""Plain float64 reference of the wideband receiver: a channelizer in
front of reference/receiver.py's chain.

For each of the stations it is given (`indices` into the antenna's
`offsets_hz`): the stream's u8 IQ decoded ((x - 128)/128), mixed down by
an exact oscillator (the phase an integer count of the offset's cycles,
reduced modulo the stream's rate), low-pass filtered by the channelizer's
windowed sinc (`taps` at the stream's rate, `cutoff`) and decimated to
the mode's RF rate; then RefReceiver on the stations' basebands, handed
as 128 + 128 x (float64, which it decodes back).  Every stage carries its
state, so steps of any aligned size give the same outputs.

`precision` adds two stages to reference/receiver.py's:
  channel_taps  the channelizer's low-pass taps
  channel_out   the channelized basebands
"""

from __future__ import annotations

import torch

from benchmark.reference import firdes
from benchmark.reference.modes import MODES
from benchmark.reference.receiver import (RefReceiver, fir, lower,
                                          quantize_taps, round_to)

__all__ = ["RefWideband", "build", "lower"]


class RefWideband:
    def __init__(self, mode: int, antenna: dict, indices: list, *,
                 rds: bool, precision: dict | None = None, taps: int = 101,
                 cutoff: float = 100e3, device="cpu"):
        cfg = MODES[mode]
        self.fs = int(antenna["fs"])
        self.decim = self.fs // cfg.rf_fs
        self.device = torch.device(device)
        self.prec = dict(precision or {})
        self.freqs = torch.tensor([int(antenna["offsets_hz"][i])
                                   for i in indices],
                                  device=self.device)[:, None]
        self.h = torch.tensor(
            quantize_taps(firdes.lowpass(self.fs, cutoff, taps),
                          self.prec.get("channel_taps")),
            dtype=torch.float64, device=self.device)
        k = len(indices)
        self.tail = torch.zeros(2 * k, taps - 1, dtype=torch.float64,
                                device=self.device)
        self.index = 0                   # stream samples so far
        self.rx = RefReceiver(mode, k, rds=rds, precision=precision,
                              device=self.device)

    def channelize(self, u8: torch.Tensor) -> torch.Tensor:
        """(k, 2 m) interleaved float64 basebands at the RF rate of the
        (1, 2 n) stream step u8."""
        x = (u8.reshape(-1).to(self.device, torch.float64) - 128.0) / 128.0
        xi, xq = x[0::2], x[1::2]
        n = xi.shape[0]
        i = torch.arange(self.index, self.index + n, device=self.device)
        ang = (2.0 * torch.pi / self.fs) * ((self.freqs * i) % self.fs
                                            ).to(torch.float64)
        c, s = torch.cos(ang), torch.sin(ang)
        # x e^{-j ang}: the station's offset moved to 0 Hz
        mixed = torch.cat([xi * c + xq * s, xq * c - xi * s])
        y, self.tail = fir(mixed, self.tail, self.h, self.decim)
        self.index += n
        y = round_to(y, self.prec.get("channel_out"))
        k = y.shape[0] // 2
        return torch.stack([y[:k], y[k:]], dim=-1).reshape(k, -1)

    def process(self, u8: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.rx.process(128.0 + 128.0 * self.channelize(u8))


def build(config: dict, k: int, *, precision: dict | None = None,
          device="cpu", antenna: dict, indices: list) -> RefWideband:
    """The reference of a configuration that names `wideband`, over the
    antenna's stations `indices` (k of them)."""
    if len(indices) != k:
        raise ValueError(f"{len(indices)} indices for {k} stations")
    ch = config["channelizer"]
    return RefWideband(config["mode"], antenna, indices,
                       rds="rds_soft" in config["outputs"],
                       precision=precision, taps=ch["taps"],
                       cutoff=ch["cutoff"], device=device)
