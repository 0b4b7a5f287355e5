"""Traffic synthesis: seeded FM stereo + RDS broadcasts as RTL-SDR u8 IQ.

A torch (float64, on any device) form of sdr_tpu_torch/tx.py
`synthesize_capture` / `make_multiplex` and of the RDS transmit side
(sdr_tpu_torch/rds/tx.py, rds/groups.py, rds/matrix.py `encode_block`,
rds/decode.py), frozen from commit c6f277a, with one change: every
component is periodic in the buffer's length, so a buffer looped end to
end is one continuous broadcast.  Tones, the pilot and the CFO have whole
cycles in the buffer; the RDS symbols are shaped circularly (the RRC pulse
evaluated at each sample, as the transmit FIR and resampler approximate);
the group stream restarts on a group boundary, the bits left over after
the last whole group are zeros with the differential code's state brought
back to its start; a DC term of the multiplex below 1/(2 kf T) closes
the FM phase to a whole number of turns.

Multiplex (ITU-R BS.450): m = a_mono (L+R)/2 + a_pilot cos(th)
  + a_stereo (L-R)/2 cos(2 th) + a_rds r(t) cos(3 th), th the pilot phase;
FM with 75 kHz deviation; complex Gaussian noise of `noise_db` dB per
component; u8 = round(128 + 128 * 0.9 * (I, Q) + dither).

`synthesize` is `baseband` (the programme's clean complex baseband at any
rate, before noise and rounding) and then `quantize`.  `antenna_stream`
puts several programmes' basebands on one antenna stream: each station
shifted in time, mixed to its offset by an oscillator of whole turns over
the buffer and scaled by its level, summed one at a time, the sum scaled
to its share of u8 full scale, noise added once, rounded once.
"""

from __future__ import annotations

import dataclasses
import string

import numpy as np
import torch

PILOT_HZ = 19_000
SYMBOL_RATE = 2375            # biphase symbols/s; bits at half that
OFFSET_WORDS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "C'": 0x350, "D": 0x1B4}
GENPOLY = 0b10110111001       # x^10 + x^8 + x^7 + x^5 + x^4 + x^3 + 1


def encode_block(info16: int, offset: str) -> np.ndarray:
    """16 info bits + checkword (info x^10 mod g, plus the offset word):
    the 26 bits, first transmitted first."""
    v = info16 << 10
    for i in range(25, 9, -1):
        if (v >> i) & 1:
            v ^= GENPOLY << (i - 10)
    word = (info16 << 10) | (v ^ OFFSET_WORDS[offset])
    return np.array([(word >> (25 - i)) & 1 for i in range(26)], np.uint8)


def group_words(pi: int, pty: int, gtype: int, payload5: int, b3: int,
                b4: int) -> tuple[int, int, int, int]:
    """The four info words of a version-A group."""
    return (pi, (gtype << 12) | (pty << 5) | (payload5 & 0x1F), b3, b4)


def group_stream(pi: int, pty: int, ps: str, rt: str, n_groups: int
                 ) -> list[tuple[int, int, int, int]]:
    """Alternating 0A (PS, 2 characters, music flag set, AF 0xE0E0) and 2A
    (radio text, 4 characters) groups, as rds/tx.py
    `standard_group_stream`."""
    out = []
    for g in range(n_groups):
        if g % 2 == 0:
            seg = (g // 2) % 4
            c = ps[2 * seg:2 * seg + 2]
            out.append(group_words(pi, pty, 0, 0x08 | seg, 0xE0E0,
                                   (ord(c[0]) << 8) | ord(c[1])))
        else:
            seg = (g // 2) % 8
            c = rt[4 * seg:4 * seg + 4]
            out.append(group_words(pi, pty, 2, seg,
                                   (ord(c[0]) << 8) | ord(c[1]),
                                   (ord(c[2]) << 8) | ord(c[3])))
    return out


def group_bits(words) -> np.ndarray:
    return np.concatenate([encode_block(w, o) for w, o in
                           zip(words, ("A", "B", "C", "D"))])


@dataclasses.dataclass
class Programme:
    """One broadcast: its PI and PS, the groups it sends, and its u8 IQ
    buffer (2 n bytes, interleaved)."""
    pi: int
    ps: str
    groups: list
    u8: torch.Tensor


def _draw(rng: np.random.Generator, lo_hi):
    lo, hi = lo_hi
    return float(rng.uniform(lo, hi))


def _cycles(k: int, n: int, i: torch.Tensor) -> torch.Tensor:
    """k i / n modulo 1, exact (integers), as float64 turns."""
    return ((k * i) % n).to(torch.float64) / n


def rrc_pulse(x: torch.Tensor, beta: float = 0.9) -> torch.Tensor:
    """The root-raised-cosine pulse of firdes.root_raised_cosine at x
    symbol periods (without its 1/sqrt(ts) scale)."""
    pi = np.pi
    num = (torch.sin(pi * x * (1 - beta))
           + 4 * beta * x * torch.cos(pi * x * (1 + beta)))
    den = pi * x * (1 - (4 * beta * x) ** 2)
    h = num / torch.where(den == 0.0, 1.0, den)
    h = torch.where(x == 0.0, 1 - beta + 4 * beta / pi, h)
    hs = (beta / np.sqrt(2.0)) * ((1 + 2 / pi) * np.sin(pi / (4 * beta))
                                  + (1 - 2 / pi) * np.cos(pi / (4 * beta)))
    sing = torch.isclose(x.abs(), torch.tensor(1.0 / (4 * beta),
                                               dtype=x.dtype,
                                               device=x.device))
    return torch.where(sing, hs, h)


def rds_baseband(bits: np.ndarray, n: int, fs: int, device,
                 span: float = 75 / 16) -> torch.Tensor:
    """Differential + biphase coded bits, RRC-shaped, at fs, circular
    over n samples (n fs-samples hold exactly len(bits) bits)."""
    diff = np.bitwise_xor.accumulate(bits.astype(np.uint8))
    sym = np.empty(2 * len(diff))
    sym[0::2] = np.where(diff == 1, 1.0, -1.0)
    sym[1::2] = -sym[0::2]
    symbols = torch.tensor(sym, dtype=torch.float64, device=device)
    n_sym = len(sym)
    i = torch.arange(n, device=device)
    # symbol time of sample i: i * 2375 / fs, split into integer and fraction
    num, den = SYMBOL_RATE, fs
    base = (num * i) // den
    frac = ((num * i) % den).to(torch.float64) / den
    out = torch.zeros(n, dtype=torch.float64, device=device)
    reach = int(np.ceil(span))
    for j in range(-reach, reach + 1):
        x = frac - j
        pulse = torch.where(x.abs() <= span, rrc_pulse(x), 0.0)
        out += symbols[(base + j) % n_sym] * pulse
    return out / out.abs().max()


def synthesize(n: int, fs: int, rng: np.random.Generator, sig: dict,
               gen: torch.Generator, device) -> Programme:
    """One programme of n IQ pairs at fs (module doc), its parameters drawn
    from `rng` by the ranges in `sig`, its noise from `gen`."""
    prog, z = baseband(n, fs, rng, sig, device)
    sigma = 10 ** (_draw(rng, sig["noise_db"]) / 20.0)
    prog.u8 = quantize(interleaved(z), sigma, sig["amplitude"], gen)
    return prog


def interleaved(z: torch.Tensor) -> torch.Tensor:
    """(2n,) float64 I, Q, I, Q, ... of a complex128 stream (a copy)."""
    return torch.view_as_real(z).reshape(-1).clone()


def quantize(iq: torch.Tensor, sigma: float, amplitude: float,
             gen: torch.Generator) -> torch.Tensor:
    """u8 = round(128 + 128 amplitude (iq + noise) + dither), clamped:
    complex Gaussian noise of sigma per component, and uniform dither of
    one step, both from `gen`.  iq: interleaved float64, changed in
    place."""
    n2, dev = iq.shape[0], iq.device
    iq += sigma * torch.randn(n2, generator=gen, dtype=torch.float64,
                              device=dev)
    iq = iq * (amplitude * 128.0) + 128.0
    iq += torch.rand(n2, generator=gen, dtype=torch.float64,
                     device=dev) - 0.5
    return torch.clamp(torch.round(iq), 0, 255).to(torch.uint8)


def baseband(n: int, fs: int, rng: np.random.Generator, sig: dict,
             device) -> tuple[Programme, torch.Tensor]:
    """A programme's clean complex baseband: n samples at fs of unit
    magnitude (complex128), before noise and u8 rounding; every parameter
    but the noise level drawn from `rng`, in `synthesize`'s order.  The
    programme's `u8` is None."""
    i = torch.arange(n, device=device)
    two_pi = 2.0 * np.pi
    # n samples hold n/fs seconds; a tone of k/(n/fs) Hz has k whole cycles
    seconds = n / fs
    lo, hi = sig["tone_hz"]

    def channel():
        x = torch.zeros(n, dtype=torch.float64, device=device)
        for _ in range(sig["tones_per_channel"]):
            k = int(rng.integers(int(lo * seconds), int(hi * seconds)))
            amp = sig["tone_amplitude"] / sig["tones_per_channel"]
            x += amp * torch.sin(two_pi * _cycles(k, n, i)
                                 + rng.uniform(0, two_pi))
        return x

    left, right = channel(), channel()
    # pilot phase: PILOT_HZ * seconds whole cycles over the buffer
    theta = (two_pi * _cycles(int(round(PILOT_HZ * seconds)), n, i)
             + rng.uniform(0, two_pi))
    m = (sig["a_mono"] * (left + right) / 2
         + sig["a_pilot"] * torch.cos(theta)
         + sig["a_stereo"] * ((left - right) / 2) * torch.cos(2 * theta))
    n_bits = n * SYMBOL_RATE // (2 * fs)
    if n_bits * 2 * fs != n * SYMBOL_RATE:
        raise ValueError(f"{n} samples at {fs} do not hold whole RDS bits")
    pi = int(rng.integers(0x1000, 0x10000))
    letters = string.ascii_uppercase + string.digits
    ps = "".join(rng.choice(list(letters), 8))
    rt = "".join(rng.choice(list(letters + " "), 32))
    pty = int(rng.integers(0, 32))
    if n_bits // 104 < 8:
        raise ValueError("a loop must carry 8 groups: the whole PS name")
    groups = group_stream(pi, pty, ps, rt, n_bits // 104)
    bits = np.zeros(n_bits, np.uint8)
    # the differential code's state returns to its start once a loop: an
    # even number of ones, by a spare bit or by the last 0A group's AF code
    for af in range(0xE0E0, 0xE0F0):
        if groups:
            last = max(g for g in range(len(groups)) if g % 2 == 0)
            groups[last] = groups[last][:2] + (af, groups[last][3])
            bits[:104 * len(groups)] = np.concatenate([group_bits(g)
                                                       for g in groups])
        if n_bits % 104 or bits.sum() % 2 == 0:
            break
    if n_bits % 104:
        bits[-1] = bits.sum() % 2
    elif bits.sum() % 2:
        raise ValueError("no AF code gives an even group stream")
    a_rds = _draw(rng, sig["a_rds"])
    m = m + a_rds * rds_baseband(bits, n, fs, device) * torch.cos(3 * theta)
    kf = float(sig["kf"])
    turns = kf * torch.cumsum(m, 0) / fs
    # close the FM phase to whole turns over the buffer: a DC offset of m
    excess = turns[-1] - torch.round(turns[-1])
    turns = turns - excess * (i + 1).to(torch.float64) / n
    cfo_k = int(round(_draw(rng, sig["cfo_hz"]) * seconds))
    turns = turns + _cycles(cfo_k % n, n, i)
    phase = two_pi * torch.remainder(turns, 1.0)
    z = torch.complex(torch.cos(phase), torch.sin(phase))
    return Programme(pi=pi, ps=ps, groups=groups, u8=None), z


def antenna_stream(basebands: list, station_programme: list, shifts,
                   turns, gains, sigma: float, amplitude: float,
                   gen: torch.Generator) -> torch.Tensor:
    """One antenna stream, (2n,) u8 interleaved, of K stations: station s
    is programme `station_programme[s]`'s baseband (complex128, n samples)
    started `shifts[s]` samples in (it loops), mixed up by `turns[s]` whole
    turns over the n samples (exact: integer sample counts) and scaled by
    `gains[s]`.  The sum is scaled to a peak of one on I and Q, then to
    `amplitude` of u8 full scale by `quantize`, with noise of sigma."""
    n = basebands[0].shape[0]
    dev = basebands[0].device
    i = torch.arange(n, device=dev)
    total = torch.zeros(n, dtype=torch.complex128, device=dev)
    for s, p in enumerate(station_programme):
        z = torch.roll(basebands[p], -int(shifts[s]))
        z *= torch.polar(torch.full((), float(gains[s]), dtype=torch.float64,
                                    device=dev),
                         2.0 * np.pi * _cycles(int(turns[s]) % n, n, i))
        total += z
        del z               # freed before the next station's copy
    iq = interleaved(total)
    del total
    iq /= iq.abs().max()
    return quantize(iq, sigma, amplitude, gen)
