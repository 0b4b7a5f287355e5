"""The carrier loops as CUDA kernels: the sequential PLL and the chunked
frozen-feedback PLL for one or several instances.

Port of sdr_tpu/ops/pallas/pll_kernel.py: `_atan2_poly` (`atan2_poly`),
`pll_pallas` (kernel `_pll_kernel`; `pll_loop_multi` runs several such
loops in one launch), `pll_pallas_chunked`
(`_pll_chunked_kernel`) and `pll_pallas_chunked_multi`
(`_pll_chunked_kernel_multi`).  Both kernels are in csrc/pll.cu.  Each
takes an `exact` flag, libm atan2f in place of the polynomial, so that it
also runs the scan engines `ops.pll.pll` (every mode of it) and
`ops.pll.pll_chunked`.  What bounds them on an H100 and what their design
does about it: see the source's header; times in PERF.md.

The reference tiles time into calls of at most 4096 rows and pads the
channels to 128 lanes to bound its VMEM working set; neither changes the
math, and the port copies neither (there is no channel limit here).

A CUDA tensor goes to the kernel, a CPU tensor to the plain PyTorch
version beside it (`pll_kernel_reference`, `pll_chunked_kernel_reference`);
there is no fallback from one to the other.  `pll_chunked_kernel_order`
runs the plain chunked loop with its sums in the kernel's order
(`kernel_order_sums`), so that the tests can hold that order to the
reference.  Each launch adds one to
`build.LAUNCHES["pll"]` (the sequential loop, one launch for all its
instances), `["pll_chunked"]` (the
chunked loop, one instance) or `["pll_chunked_multi"]` (several).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sdr_tpu_torch.ops.cuda import build
from sdr_tpu_torch.ops.pll import (PLLState, _largest_divisor_at_most,
                                   _pll_plain, loop_params, state_rows)

MAX_GROUPS = 4   # instances of one launch (csrc/pll.cu kMaxLoops, kMaxGroups)
_PI = float(np.float32(np.pi))
_PI_2 = float(np.float32(np.pi / 2))


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 by octant reduction and a degree-9 minimax polynomial, the
    reference's phase detector for its Pallas loops (accurate to ~1e-5
    rad).  Like the reference, atan2(0, 0) = 0 and atan2(-0, x < 0) = +pi;
    float32, each operation rounded in the reference's order."""
    ay, ax = y.abs(), x.abs()
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.where(swap, ay, ax)
    z = num / torch.clamp_min(den, 1e-30)
    a = z * z
    p = z * (0.99997726 + a * (-0.33262347 + a * (0.19354346 + a * (
        -0.11643287 + a * (0.05265332 + a * -0.01172120)))))
    r = torch.where(swap, _PI_2 - p, p)
    r = torch.where(x < 0, _PI - r, r)
    return torch.where(y < 0, -r, r)


def _state_out(out: torch.Tensor, lead, trig_offset=None) -> PLLState:
    """(5, C) or (4, C) rows -> PLLState of lead-shaped leaves; a 4-row
    stack takes trig_offset from the caller."""
    rows = [r.reshape(lead) for r in out]
    if trig_offset is not None:
        rows.append(trig_offset)
    return PLLState(*rows)


# ------------------------------------------------------- the sequential loop
def pll_loop(x: torch.Tensor, state: PLLState, *, freq: float, fs: float,
             nco_scale: float = 1.0, phase_adjust: float = 0.0,
             norm_bandwidth: float = 0.01, wrap_phase: bool = True,
             lag_correction: bool = True, exact: bool = True):
    """The per-sample loop over x (..., n), float32 or bfloat16: returns
    (nco (..., n) float32, new_state).  exact: libm atan2 (the scan
    engine) or the polynomial (the reference's Pallas kernel)."""
    if x.is_cuda:
        (nco,), (new,) = _loop_kernel(
            (x,), (state,), ((freq, fs, nco_scale, phase_adjust,
                              norm_bandwidth),),
            wrap_phase, lag_correction, exact)
        return nco, new
    if x.device.type != "cpu":
        raise ValueError(f"no PLL kernel for device {x.device}")
    return pll_kernel_reference(
        x, state, freq=freq, fs=fs, nco_scale=nco_scale,
        phase_adjust=phase_adjust, norm_bandwidth=norm_bandwidth,
        wrap_phase=wrap_phase, lag_correction=lag_correction, exact=exact)


def pll_pallas(x: torch.Tensor, state: PLLState, *, freq: float, fs: float,
               nco_scale: float = 1.0, phase_adjust: float = 0.0,
               norm_bandwidth: float = 0.01, lag_correction: bool = True,
               chunk: int = 4096, interpret: bool = False):
    """The reference's `pll_pallas` (pll_impl='pallas'): the sequential
    loop with the polynomial detector, always wrapping the phase.
    `chunk` and `interpret` (TPU-lowering knobs) are accepted and have no
    effect: a CUDA tensor always launches the kernel."""
    return pll_loop(x, state, freq=freq, fs=fs, nco_scale=nco_scale,
                    phase_adjust=phase_adjust, norm_bandwidth=norm_bandwidth,
                    wrap_phase=True, lag_correction=lag_correction,
                    exact=False)


def pll_loop_multi(xs, states, *, params, wrap_phase: bool = True,
                   lag_correction: bool = True, exact: bool = True):
    """G sequential loops in one launch over inputs (..., n), float32 or
    bfloat16, with a common n: params holds one (freq, fs,
    nco_scale, phase_adjust, norm_bandwidth) per instance.  Returns
    (ncos, new_states), tuples in input order; each instance equals its
    own `pll_loop` bit for bit.  The receiver runs its pilot and RDS loops
    through it, so that they run side by side on the card.  On the CPU the
    plain loop runs once per instance."""
    if not len(xs) == len(states) == len(params) >= 1:
        raise ValueError("xs, states and params must have one entry each")
    n = xs[0].shape[-1]
    if any(x.shape[-1] != n for x in xs):
        raise ValueError("inputs must share n")
    if xs[0].is_cuda:
        return _loop_kernel(xs, states, params, wrap_phase, lag_correction,
                            exact)
    if xs[0].device.type != "cpu":
        raise ValueError(f"no PLL kernel for device {xs[0].device}")
    outs = [pll_kernel_reference(
        x, st, freq=p[0], fs=p[1], nco_scale=p[2], phase_adjust=p[3],
        norm_bandwidth=p[4], wrap_phase=wrap_phase,
        lag_correction=lag_correction, exact=exact)
        for x, st, p in zip(xs, states, params)]
    return tuple(o[0] for o in outs), tuple(o[1] for o in outs)


def _instances(xs, states, params, out_rows: int):
    """The launch arguments of G loop instances: checks the inputs, makes
    each row block contiguous and allocates its nco and its (out_rows, C)
    state output.  Mixed float32 and bfloat16 inputs run as float32: the
    kernels widen bf16 exactly, so that gives their bits.  Returns (x_bf16,
    n, ptrs (4 per instance), channels, params (G, 6) float32, outs of
    (lead, nco, state rows), keep: the copies whose addresses are taken)."""
    dev = xs[0].device
    if any(x.dtype not in (torch.float32, torch.bfloat16) for x in xs):
        raise TypeError("inputs must be float32 or bfloat16")
    if len({x.dtype for x in xs}) > 1:
        xs = [x.float() for x in xs]
    if len(xs) > MAX_GROUPS:
        raise ValueError(f"at most {MAX_GROUPS} instances per launch")
    if any(t.device != dev for x, s in zip(xs, states) for t in (x, *s)):
        raise ValueError("all inputs must be on one device")
    ptrs, channels, keep, outs = [], [], [], []
    for x, state in zip(xs, states):
        lead, n, xr, st = state_rows(x, state)
        if tuple(st.shape[1:]) != (xr.shape[0],):
            raise ValueError("state leaves must have x's leading shape")
        xr = xr.contiguous()
        c = xr.shape[0]
        nco = torch.empty((c, n), dtype=torch.float32, device=dev)
        out = torch.empty((out_rows, c), dtype=torch.float32, device=dev)
        ptrs += [xr.data_ptr(), st.data_ptr(), nco.data_ptr(),
                 out.data_ptr()]
        channels.append(c)
        keep += [xr, st]
        outs.append((lead, nco, out))
    g = len(xs)
    prm = np.asarray([loop_params(*p) for p in params], np.float32)
    return (int(xs[0].dtype == torch.bfloat16), n,
            (ctypes.c_longlong * (4 * g))(*ptrs), (ctypes.c_int * g)(*channels),
            prm, outs, keep)


def _loop_kernel(xs, states, params, wrap_phase, lag_correction, exact):
    x_bf16, n, ptrs, channels, prm, outs, _keep = _instances(
        xs, states, params, 5)
    stream = torch.cuda.current_stream(xs[0].device).cuda_stream
    build.check(build.library().sdr_pll_multi(
        len(xs), ptrs, channels, prm.ctypes.data, x_bf16, n, int(exact),
        int(wrap_phase), int(lag_correction), stream))
    build.LAUNCHES["pll"] += 1
    return (tuple(nco.reshape(*lead, n) for lead, nco, _ in outs),
            tuple(_state_out(out, lead) for lead, _, out in outs))


def chain_floor(x: torch.Tensor, state: PLLState, *, params,
                wrap_phase: bool = True, lag_correction: bool = True,
                exact: bool = True):
    """The sequential loop's chain floor on the card: one thread runs the
    recurrence over x (n,) float32, n <= 8192, staged in shared memory,
    with no NCO, no barriers and no stores in the timed loop (csrc/pll.cu
    `chain_floor_kernel`).  Modes: exact wrap with lag, polynomial wrap
    with lag, exact counter without lag.  Returns (clock64 cycles a
    sample, %globaltimer nanoseconds a sample at the clock the loop ran,
    the final state as a (5,) float32 tensor: integ, acc, fbi, fbq,
    trig).  A measurement, not a path of the receiver: not counted in
    build.LAUNCHES."""
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError("x must be a 1-d float32 CUDA tensor")
    n = x.shape[0]
    st = torch.stack([s.reshape(()).float() for s in state]).to(x.device)
    out = torch.empty(6, dtype=torch.float32, device=x.device)
    timing = torch.zeros(2, dtype=torch.int64, device=x.device)
    x = x.contiguous()
    build.check(build.library().sdr_pll_chain_floor(
        x.data_ptr(), n, st.data_ptr(), out.data_ptr(), timing.data_ptr(),
        *loop_params(*params), int(exact), int(wrap_phase),
        int(lag_correction), torch.cuda.current_stream(x.device).cuda_stream))
    cycles, ns = timing.tolist()
    return cycles / n, ns / n, out[:5]


def chunk_floor(xs, states, *, params, chunk: int, exact: bool = False):
    """The chunked loop's chain floor on the card: one warp per instance
    (1 or 2, the joint launch's) runs only the per-chunk dependent chain
    of the chunked kernel (the prediction's sincosf, the detector, the
    butterfly of the carried sums, the PI update and the wrap) over x (n,)
    float32, n <= 4096 and a multiple of chunk, staged in shared memory
    (csrc/pll.cu `chunk_floor_kernel`).
    Returns (clock64 cycles a sample, %globaltimer nanoseconds a sample,
    each the slowest instance's, and the final states as a (G, 4) float32
    tensor of integ, acc, cos acc, sin acc: the bits of pll_chunked_loop's
    new state for the same input).  A measurement, not a path of the
    receiver: not counted in build.LAUNCHES."""
    g = len(xs)
    if not 1 <= g == len(states) == len(params) <= 2:
        raise ValueError("one or two instances, each with a state and "
                         "params")
    n = xs[0].shape[-1]
    dev = xs[0].device
    if any(not x.is_cuda or x.dtype != torch.float32 or x.shape != (n,)
           for x in xs):
        raise ValueError("xs must be 1-d float32 CUDA tensors of one n")
    x = torch.stack(list(xs)).contiguous()
    st = torch.stack([torch.stack([s.integrator.reshape(()).float(),
                                   s.phase_acc.reshape(()).float()])
                      for s in states]).to(dev)
    out = torch.empty((g, 4), dtype=torch.float32, device=dev)
    timing = torch.zeros((g, 2), dtype=torch.int64, device=dev)
    prm = np.asarray([loop_params(*p) for p in params], np.float32)
    build.check(build.library().sdr_pll_chunk_floor(
        x.data_ptr(), n, g, chunk, st.data_ptr(), out.data_ptr(),
        timing.data_ptr(), prm.ctypes.data, int(exact),
        torch.cuda.current_stream(dev).cuda_stream))
    cycles, ns = timing.max(dim=0).values.tolist()
    return cycles / n, ns / n, out


def sincos_differences(device="cuda") -> int:
    """The number of finite float32 arguments where sincosf differs in
    any bit from (sinf, cosf) on the card: 0 allows the sequential loop's
    one sincosf for its feedback pair (csrc/pll.cu `chain_step`)."""
    differ = torch.zeros(1, dtype=torch.int64, device=device)
    build.check(build.library().sdr_sincos_check(
        differ.data_ptr(), torch.cuda.current_stream(device).cuda_stream))
    return int(differ.item())


# ---------------------------------------------------------- the chunked loop
def pll_chunked_loop(xs, states, *, params, chunk: int,
                     lag_correction: bool = True, exact: bool = False):
    """G chunked loops over inputs (..., n) with a common n, a multiple of
    chunk: params holds one (freq, fs, nco_scale, phase_adjust,
    norm_bandwidth) per instance.  Returns (ncos, new_states), tuples in
    input order; each state's feedback is (cos, sin) of its carried phase
    and its trig_offset passes through."""
    if not len(xs) == len(states) == len(params) >= 1:
        raise ValueError("xs, states and params must have one entry each")
    n = xs[0].shape[-1]
    if any(x.shape[-1] != n for x in xs) or n % chunk:
        raise ValueError(f"inputs must share n, a multiple of chunk {chunk}")
    if xs[0].is_cuda:
        return _chunked_kernel(xs, states, params, chunk, lag_correction,
                               exact)
    if xs[0].device.type != "cpu":
        raise ValueError(f"no PLL kernel for device {xs[0].device}")
    return pll_chunked_kernel_reference(xs, states, params=params,
                                        chunk=chunk,
                                        lag_correction=lag_correction,
                                        exact=exact)


def pll_pallas_chunked(x: torch.Tensor, state: PLLState, *, freq: float,
                       fs: float, nco_scale: float = 1.0,
                       phase_adjust: float = 0.0,
                       norm_bandwidth: float = 0.01,
                       lag_correction: bool = True, chunk: int = 32,
                       interpret: bool = False):
    """The reference's `pll_pallas_chunked` (pll_impl='pallas_chunked'):
    the chunked loop with the polynomial detector; chunk shrinks to the
    largest divisor of n that is at most min(chunk, 4096).
    `interpret` (a TPU-lowering knob) is accepted and has no effect."""
    chunk = _largest_divisor_at_most(x.shape[-1], min(chunk, 4096))
    (nco,), (new,) = pll_chunked_loop(
        (x,), (state,),
        params=((freq, fs, nco_scale, phase_adjust, norm_bandwidth),),
        chunk=chunk, lag_correction=lag_correction)
    return nco, new


def pll_pallas_chunked_multi(xs, states, *, params,
                             lag_correction: bool = True, chunk: int = 32,
                             interpret: bool = False):
    """The reference's `pll_pallas_chunked_multi`: G instances (the stereo
    pilot loop and the RDS carrier loop) with their own parameters in one
    launch; chunk clamped as in pll_pallas_chunked.
    `interpret` (a TPU-lowering knob) is accepted and has no effect."""
    chunk = _largest_divisor_at_most(xs[0].shape[-1], min(chunk, 4096))
    return pll_chunked_loop(tuple(xs), tuple(states), params=tuple(params),
                            chunk=chunk, lag_correction=lag_correction)


def _chunked_kernel(xs, states, params, chunk, lag_correction, exact):
    x_bf16, n, ptrs, channels, prm, outs, _keep = _instances(
        xs, states, params, 4)
    g = len(xs)
    stream = torch.cuda.current_stream(xs[0].device).cuda_stream
    build.check(build.library().sdr_pll_chunked(
        g, ptrs, channels, prm.ctypes.data, x_bf16, n, chunk, int(exact),
        int(lag_correction), stream))
    build.LAUNCHES["pll_chunked" if g == 1 else "pll_chunked_multi"] += 1
    return (tuple(nco.reshape(*lead, n) for lead, nco, _ in outs),
            tuple(_state_out(out, lead, state.trig_offset)
                  for (lead, _, out), state in zip(outs, states)))


# --------------------------------------------------------------- plain torch
def pll_kernel_reference(x: torch.Tensor, state: PLLState, *, freq: float,
                         fs: float, nco_scale: float = 1.0,
                         phase_adjust: float = 0.0,
                         norm_bandwidth: float = 0.01,
                         wrap_phase: bool = True,
                         lag_correction: bool = True, exact: bool = True):
    """Plain PyTorch sequential loop, pll_loop's signature: the scan
    engine's plain loop (`ops.pll`), with the polynomial detector where
    exact is off."""
    return _pll_plain(x, state, (freq, fs, nco_scale, phase_adjust,
                                 norm_bandwidth), wrap_phase, lag_correction,
                      torch.atan2 if exact else atan2_poly)


def pll_chunked_kernel_reference(xs, states, *, params, chunk: int,
                                 lag_correction: bool = True,
                                 exact: bool = False):
    """Plain PyTorch chunked loop for G instances, pll_chunked_loop's
    signature: a loop over chunks in the reference kernel's form
    (cs_integ = j*integ + ki*cumsum(ce)), vectorised over every
    instance's channels with per-lane parameters."""
    return _chunked_plain(xs, states, params, chunk, lag_correction, exact,
                          _cumsum_sums)


def pll_chunked_kernel_order(xs, states, *, params, chunk: int,
                             lag_correction: bool = True,
                             exact: bool = False):
    """The chunked loop with its sums in the CUDA kernel's order
    (`kernel_order_sums`), pll_chunked_loop's signature: what the tests
    hold against the reference, so that a kernel whose sums take that
    order is known to stay within its gates.  Not a path of the port."""
    return _chunked_plain(xs, states, params, chunk, lag_correction, exact,
                          kernel_order_sums)


def _cumsum_sums(e: torch.Tensor, chunk: int):
    ce = torch.cumsum(e, dim=-1)
    cs = torch.cumsum(ce, dim=-1)
    return ce, cs, ce[..., -1:], cs[..., -1:]


def kernel_order_sums(e: torch.Tensor, chunk: int):
    """One chunk's sums in csrc/pll.cu's order, float32 each operation:
    e (..., K) -> (ce, cs, ce_K, cs_K).  Per sample (the NCO warp), ce =
    cumsum(e) and cs = cumsum(ce) by one pair scan over segments of W
    lanes (W = K rounded up to a power of two, at most 32), the earlier
    sub-blocks' sums carried in; for the carried state (the chain),
    ce_K = sum e and cs_K = sum (K - j) e_j, each lane's sums over its
    sub-blocks, then a xor butterfly over the W lanes."""
    k = chunk
    w = min(32, 1 << (k - 1).bit_length())
    rpc = -(-k // w)
    lead = e.shape[:-1]
    rows = torch.nn.functional.pad(e, (0, rpc * w - k)).reshape(
        *lead, rpc, w)
    lane = torch.arange(w, device=e.device)
    # the chain: the lane's sums, then the butterfly
    se = torch.zeros((*lead, w), dtype=torch.float32, device=e.device)
    sw = torch.zeros_like(se)
    for sb in range(rpc):
        j = sb * w + lane
        se = se + rows[..., sb, :]
        sw = sw + (k - j).float() * rows[..., sb, :]
    d = 1
    while d < w:
        se = se + se[..., lane ^ d]
        sw = sw + sw[..., lane ^ d]
        d <<= 1
    # the NCO: the pair scan a row, the chunk's earlier rows carried in
    ces, css = [], []
    for sb in range(rpc):
        ce = rows[..., sb, :].clone()
        cs = ce.clone()
        d = 1
        while d < w:
            ca = torch.zeros_like(ce)
            sa = torch.zeros_like(cs)
            ca[..., d:], sa[..., d:] = ce[..., :-d], cs[..., :-d]
            up = lane >= d
            cs = torch.where(up, (sa + cs) + float(d) * ca, cs)
            ce = torch.where(up, ca + ce, ce)
            d <<= 1
        if sb > 0:
            cs = (cs_c + (lane + 1).float() * ce_c) + cs
            ce = ce_c + ce
        ce_c, cs_c = ce[..., -1:], cs[..., -1:]
        ces.append(ce)
        css.append(cs)
    ce = torch.cat(ces, dim=-1)[..., :k]
    cs = torch.cat(css, dim=-1)[..., :k]
    return ce, cs, se[..., :1], sw[..., :1]


def _chunked_plain(xs, states, params, chunk, lag_correction, exact, sums):
    """The chunked loop over G instances' channels with per-lane
    parameters; sums(e, chunk) -> (cumsum(e), cumsum(cumsum(e)), and their
    last values) in the order of the version it stands for."""
    rows = [state_rows(x, s) for x, s in zip(xs, states)]
    n, dev = rows[0][1], xs[0].device
    x = torch.cat([r[2].float() for r in rows])           # (C_all, n)
    st = torch.cat([r[3] for r in rows], dim=1)
    lanes = [torch.full((r[2].shape[0], 1), float(v), dtype=torch.float32,
                        device=dev)
             for r, p in zip(rows, params)
             for v in np.asarray(loop_params(*p), np.float32)]
    kp, ki, w0, wmod, scale, adj = (
        torch.cat(lanes[k::6]) for k in range(6))           # (C_all, 1)
    detect = torch.atan2 if exact else atan2_poly
    t = torch.arange(chunk, dtype=torch.float32, device=dev)
    j = t + 1.0
    kf = float(chunk)
    integ, acc = st[0, :, None], st[1, :, None]
    out = torch.empty_like(x)
    for b in range(0, n, chunk):
        xc = x[:, b:b + chunk]
        pred = acc + t * (w0 + integ)
        e = detect(xc * -torch.sin(pred), xc * torch.cos(pred))
        ce, cs, ce_k, cs_k = sums(e, chunk)
        acc_i = acc + j * w0 + kp * ce + (j * integ + ki * cs)
        arg = acc_i - w0 if lag_correction else acc_i
        out[:, b:b + chunk] = torch.cos(arg * scale + adj)
        acc_k = acc + kf * w0 + kp * ce_k + (kf * integ + ki * cs_k)
        integ = integ + ki * ce_k
        acc = torch.remainder(acc_k, wmod)
    integ, acc = integ[:, 0], acc[:, 0]
    fin = torch.stack([integ, acc, torch.cos(acc), torch.sin(acc)])
    ncos, news, lo = [], [], 0
    for (lead, _, xr, _), state in zip(rows, states):
        c = xr.shape[0]
        ncos.append(out[lo:lo + c].reshape(*lead, n))
        news.append(_state_out(fin[:, lo:lo + c], lead, state.trig_offset))
        lo += c
    return tuple(ncos), tuple(news)
