"""The wideband channelizer's modulated filter bank as one CUDA kernel.

Port of sdr_tpu/ops/pallas/channelizer_kernel.py `PallasMFB` (the name is
kept so that each finds its counterpart).  The kernel is in
csrc/channelizer.cu and replaces the Pallas kernel `_mfb_kernel`.  With
x[d, c] the (2D, N/D) column layout of the raw interleaved stream
(x[d, c] = raw[2D*c + d]), B the (2Kp, 2D*n_shift) modulated bank (real
rows over imag rows) and T = t_cols carried history columns:

    out[r, g] = sum_{s, d} B[r, 2D*s + d] * x[d, g - T + s]
    (I, Q)[k, g] = rotate(out[k, g], out[Kp + k, g]) by e^{j theta_k(g)}

where a negative column reads the carried (2D, 128) tail, u8 decodes as
(x-128)/128, and the rotation uses the reference's factored host-f64
phasor tables: a per-tile start phasor (the carried phase composed with
the row table, K-element work per block, here in PyTorch) times the
(Kp, tile) base table.  What bounds it on an H100 and what its design
does about it: see the source's header; times in PERF.md.

`__call__` takes the flat (2N,) stream and hands the kernel a strided
view of it (no relayout); `call_cols` the pre-phased (2D, N/D) layout.
A CUDA tensor goes to the kernel, a CPU tensor to the plain PyTorch
version beside it (`mfb_reference`: im2col, `torch.matmul`, the rotation
in the same order); there is no fallback from one to the other.  Each
launch adds one to `build.LAUNCHES["mfb"]`.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.ops.channelizer import (_advance, _modulated_bank,
                                           phase_tables)
from sdr_tpu_torch.ops.cuda import build

EXT = 128          # carried columns of raw context (covers t_cols)
BLOCK_STATIONS = 32  # stations of one kernel block (csrc/channelizer.cu)


class PallasMFB:
    """Stateful modulated-filter-bank channelizer engine.

    `__call__(body, state)` with body the raw interleaved block (2N,) in
    the constructed ingest dtype (u8 or f32), or `call_cols(xbt, state)`
    with the pre-phased (2D, N/D) layout.  state = {"phase": (K,),
    "tail": (2D, 128) raw trailing columns}.  Both return ((I, Q), new
    state) with I, Q (K, N/D) in out_dtype.  Constructed by
    WidebandChannelizer(engine="pallas").
    """

    def __init__(self, coeff: np.ndarray, dphi: np.ndarray, decim: int, *,
                 tile: int = 4096,
                 compute_dtype: torch.dtype = torch.float32,
                 ingest: str = "f32",
                 out_dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        if ingest not in ("f32", "u8"):
            raise ValueError(f"ingest {ingest!r}")
        if compute_dtype not in (torch.float32, torch.bfloat16) or \
                out_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("compute_dtype and out_dtype must be float32 or "
                            "bfloat16")
        self.decim = int(decim)
        self.k = len(dphi)
        self.kp = -(-self.k // 8) * 8          # station rows, padded to 8
        self.taps = len(coeff)
        self.state_len = self.taps - 1
        self.tile = int(tile)
        self.compute_dtype = compute_dtype
        self.ingest = ingest
        self.out_dtype = out_dtype
        self.device = torch.device(device)
        self._dphi = np.asarray(dphi, np.float64)
        dphi_pad = np.concatenate([self._dphi, np.zeros(self.kp - self.k)])
        two_d = 2 * self.decim
        # column-aligned history: t_cols whole (2D)-columns cover the
        # 2*(taps-1) carried samples; delta pads the filter placement so
        # the extra-old samples multiply zero rows
        delta = (-2 * self.state_len) % two_d
        self.t_cols = (2 * self.state_len + delta) // two_d
        rhs = _modulated_bank(np.asarray(coeff, np.float64), dphi_pad)
        self._n_shift = -(-(2 * self.taps + delta) // two_d)
        if not self._n_shift <= self.t_cols + 1 <= EXT + 1:
            raise ValueError(f"{self.taps} taps need more than the {EXT} "
                             "carried columns")
        rows = two_d * self._n_shift
        b = np.zeros((rows, 2 * self.kp), np.float32)
        for l in range(self.taps):
            b[2 * l + delta, :] = rhs[:, 0, l]
            b[2 * l + 1 + delta, :] = rhs[:, 1, l]
        # station-major, real block over imag block: (2Kp, rows)
        bt = b.T
        self._bm = np.concatenate([bt[0::2], bt[1::2]], axis=0)
        # the bank as the product sees it: rounded to the compute dtype
        bm = torch.from_numpy(self._bm).to(compute_dtype).to(torch.float32)
        self._bm_dev = bm.to(self.device)
        self._bm_packed = pack_bank(bm, self.kp, compute_dtype).to(
            self.device)
        self._dev_cache: dict = {}

    def init_state(self) -> dict[str, torch.Tensor]:
        two_d = 2 * self.decim
        tail = (torch.full((two_d, EXT), 128, dtype=torch.uint8,
                           device=self.device) if self.ingest == "u8"
                else torch.zeros((two_d, EXT), dtype=torch.float32,
                                 device=self.device))
        return {"phase": torch.zeros((self.k,), dtype=torch.float32,
                                     device=self.device), "tail": tail}

    def _tables(self, n_out: int, tile: int):
        """The channelizer's factored host-f64 phasor tables
        (ops/channelizer.py `phase_tables`, stride D) with the station
        axis zero-padded to Kp: row (Kp, A) at tile starts, base (Kp,
        tile) within a tile, and the (K,) per-block phase advance."""
        row, base, adv = phase_tables(self._dphi, n_out, self.decim, tile)
        pad = ((0, self.kp - self.k), (0, 0))
        return (tuple(np.pad(x, pad) for x in row),
                tuple(np.pad(x, pad) for x in base), adv)

    def _device_tables(self, n_out: int, tile: int):
        key = (n_out, tile)
        if key not in self._dev_cache:
            (rr, ri), (br, bi), adv = self._tables(n_out, tile)
            t = lambda x: torch.from_numpy(x).to(self.device)  # noqa: E731
            self._dev_cache[key] = ((t(rr), t(ri)), (t(br), t(bi)), t(adv))
        return self._dev_cache[key]

    def __call__(self, body: torch.Tensor, state,
                 interpret: bool | None = None):
        """Channelize one raw interleaved block (2N,) -> (K, N/D) I/Q.  The
        kernel reads the block through a strided (2D, N/D) view of it."""
        two_d = 2 * self.decim
        n2 = body.shape[-1]
        if body.dim() != 1 or n2 % two_d:
            raise ValueError(f"body must be (2N,) with 2N a multiple of "
                             f"{two_d}, not {tuple(body.shape)}")
        return self.call_cols(body.reshape(n2 // two_d, two_d).T, state)

    def call_cols(self, xbt: torch.Tensor, state,
                  interpret: bool | None = None):
        """Channelize from the pre-phased (2D, N/D) column layout,
        xbt[d, c] = raw[2D*c + d].  `interpret` (a TPU-lowering knob) is
        accepted here and in `__call__` and has no effect."""
        args = self._prepare(xbt, state)
        if xbt.is_cuda:
            i_out, q_out = self._kernel(xbt, state["tail"], *args)
        elif xbt.device.type == "cpu":
            i_out, q_out = mfb_reference(self, xbt, state["tail"], *args)
        else:
            raise ValueError(f"no channelizer kernel for device "
                             f"{xbt.device}")
        return (i_out, q_out), self._next_state(xbt, state)

    def _prepare(self, xbt, state):
        """The reference's checks and the per-block rotation tables:
        returns (rotc, rots, base_r, base_i, tile)."""
        two_d, n_out = xbt.shape
        if two_d != 2 * self.decim:
            raise ValueError(f"xbt must have {2 * self.decim} rows")
        if n_out < EXT:
            raise ValueError(f"{n_out} output columns: at least {EXT} needed")
        tile = _largest_tile_at_most(n_out, self.tile)
        if tile % 128:
            raise ValueError(f"n_out {n_out} has no 128-multiple tile <= "
                             f"{self.tile}")
        (rr, ri), (br, bi), _ = self._device_tables(n_out, tile)
        pad = (0, self.kp - self.k)
        pr = torch.nn.functional.pad(torch.cos(state["phase"]), pad)
        pi = torch.nn.functional.pad(torch.sin(state["phase"]), pad)
        rotc = pr[:, None] * rr - pi[:, None] * ri        # (Kp, A)
        rots = pr[:, None] * ri + pi[:, None] * rr
        return rotc, rots, br, bi, tile

    def _next_state(self, xbt, state):
        n_out = xbt.shape[-1]
        tile = _largest_tile_at_most(n_out, self.tile)
        adv = self._device_tables(n_out, tile)[2]
        return {"phase": _advance(state["phase"], adv),
                "tail": xbt[:, n_out - EXT:].clone(
                    memory_format=torch.contiguous_format)}

    def _kernel(self, xbt, tail, rotc, rots, base_r, base_i, tile):
        two_d, n_out = xbt.shape
        if xbt.dtype not in (torch.uint8, torch.float32):
            raise TypeError("the stream must be uint8 or float32")
        if tail.dtype != xbt.dtype or tuple(tail.shape) != (two_d, EXT):
            raise ValueError(f"tail must be ({two_d}, {EXT}) {xbt.dtype}")
        tensors = (tail, rotc, rots, base_r, base_i, self._bm_packed)
        if any(t.device != xbt.device for t in tensors):
            raise ValueError("all inputs must be on one device")
        stride_d, stride_c = xbt.stride()
        if stride_d < 1 or stride_c < 1:
            raise ValueError("the stream's strides must be positive")
        tail, rotc, rots, base_r, base_i = (
            t.contiguous() for t in (tail, rotc, rots, base_r, base_i))
        i_out = torch.empty((self.k, n_out), dtype=self.out_dtype,
                            device=xbt.device)
        q_out = torch.empty_like(i_out)
        bf16 = torch.bfloat16
        stream = torch.cuda.current_stream(xbt.device).cuda_stream
        build.check(build.library().sdr_mfb(
            xbt.data_ptr(), tail.data_ptr(), int(xbt.dtype == torch.uint8),
            stride_d, stride_c, two_d, n_out, self._bm_packed.data_ptr(),
            self.kp, self.k, self._n_shift, self.t_cols, rotc.data_ptr(),
            rots.data_ptr(), rotc.shape[1], base_r.data_ptr(),
            base_i.data_ptr(), tile, int(self.compute_dtype == bf16),
            i_out.data_ptr(), q_out.data_ptr(), int(self.out_dtype == bf16),
            stream))
        build.LAUNCHES["mfb"] += 1
        return i_out, q_out


def pack_bank(bm: torch.Tensor, kp: int,
              compute_dtype: torch.dtype) -> torch.Tensor:
    """The (2Kp, rows) bank (real rows over imag rows, already rounded to
    the compute dtype) in the kernel's layout, stations zero-padded to
    groups of BLOCK_STATIONS.  float32 engine: (groups, rows, 32, 2),
    (real, imag) of each station side by side.  bf16 engine: the A
    fragments of mma.m16n8k16, (groups, 4 m-tiles, k-steps, 32 lanes, 8):
    m-tile m holds stations 8m..8m+7 with their real rows at rows 0-7 and
    their imaginary rows at rows 8-15, and lane (g, t) = (lane // 4,
    lane % 4) holds rows (g, g + 8) x columns (2t, 2t + 1) and (2t + 8,
    2t + 9) of each 16-column k-step, in the order a0 a1 a2 a3."""
    rows = bm.shape[1]
    groups = -(-kp // BLOCK_STATIONS)
    s = groups * BLOCK_STATIONS
    if compute_dtype != torch.bfloat16:
        packed = torch.zeros((s, 2, rows))
        packed[:kp, 0] = bm[:kp]
        packed[:kp, 1] = bm[kp:]
        return packed.reshape(groups, BLOCK_STATIONS, 2, rows).permute(
            0, 3, 1, 2).contiguous()
    ks = -(-rows // 16)
    re = torch.zeros((s, ks * 16))
    im = torch.zeros((s, ks * 16))
    re[:kp, :rows] = bm[:kp]
    im[:kp, :rows] = bm[kp:]
    # (groups, m-tile, k-step, row g within the m-tile, column)
    re, im = (t.reshape(groups, 4, 8, ks, 16).permute(0, 1, 3, 2, 4)
              for t in (re, im))
    lane = torch.arange(32)
    g, col = lane // 4, 2 * (lane % 4)
    # a0 = re (2t, 2t+1), a1 = im (2t, 2t+1), a2 = re (2t+8, +9), a3 = im
    vals = []
    for dc in (0, 8):
        for t in (re, im):
            vals += [t[..., g, col + dc], t[..., g, col + dc + 1]]
    return torch.stack(vals, dim=-1).to(torch.bfloat16).contiguous()


def _largest_tile_at_most(n: int, cap: int) -> int:
    """The largest 128-multiple divisor of n that is <= cap (else n)."""
    for d in range(min(cap, n), 0, -1):
        if n % d == 0 and d % 128 == 0:
            return d
    return n


# --------------------------------------------------------------- plain torch
def mfb_reference(mfb: PallasMFB, xbt, tail, rotc, rots, base_r, base_i,
                  tile):
    """Plain PyTorch channelizer: decode, im2col of the n_shift shifted
    column slices, `torch.matmul` against the bank, rotation (each op
    rounded, as the kernel rounds it)."""
    two_d, n_out = xbt.shape
    x = torch.cat([tail.to(xbt.dtype), xbt], dim=1)
    if x.dtype == torch.uint8:
        x = (x.to(torch.float32) - 128.0) / 128.0
    x = x.to(mfb.compute_dtype).to(torch.float32)
    off = EXT - mfb.t_cols
    win = x[:, off:off + n_out + mfb._n_shift - 1]
    # xim[s*2D + d, g] = x[d, g - t_cols + s]
    xim = win.unfold(1, n_out, 1).transpose(0, 1).reshape(-1, n_out)
    out = torch.matmul(mfb._bm_dev.to(xbt.device), xim)   # (2Kp, n_out)
    kp, k = mfb.kp, mfb.k
    c_r, c_i = out[:kp], out[kp:]
    a = n_out // tile
    sr, si = rotc[:, :, None], rots[:, :, None]
    br, bi = base_r[:, None, :], base_i[:, None, :]
    cos_t = (sr * br - si * bi).reshape(kp, a * tile)
    sin_t = (sr * bi + si * br).reshape(kp, a * tile)
    i_out = c_r * cos_t - c_i * sin_t
    q_out = c_r * sin_t + c_i * cos_t
    return (i_out[:k].to(mfb.out_dtype).contiguous(),
            q_out[:k].to(mfb.out_dtype).contiguous())


def call_cols_reference(mfb: PallasMFB, xbt, state):
    """`call_cols` through the plain version on any device (the card's
    checks hold the kernel against it)."""
    args = mfb._prepare(xbt, state)
    return (mfb_reference(mfb, xbt, state["tail"], *args),
            mfb._next_state(xbt, state))
