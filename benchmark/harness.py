"""The benchmark's harness: one run of one cell.

A cell (BENCHMARK.json `workloads`) names a configuration and a traffic
mix; both are data files found by name, and so is what they name:
  benchmark/configs/<config>.json   mode, the system's keyword arguments,
                                    its outputs, the precision it states,
                                    the limits of the comparison, and the
                                    names of its system and reference
  benchmark/systems/<system>.py     `build(config, blocks_per_step,
                                    device)`: the program, one step a call
  benchmark/reference/<reference>.py  `build(config, stations, precision=,
                                    device=)`: the plain reference, and
                                    `lower(precision)` for the control
  benchmark/traffic/<traffic>.json  stations, blocks a step, open
                                    (`realtime`) or `closed` loop, whether
                                    RDS is decoded, the buffer, the signal,
                                    and optionally `antenna` (below)
  benchmark/metrics/<metric>.py     `read(run)` of one per-layer metric
  benchmark/work/<config>.py        `step_work(stations, step_bytes)`

A run: build the system, synthesize the stations' broadcasts from the
seed into one (stations, n) u8 array in host memory (each row loops; n a
whole number of steps), warm up, then drive `Receiver.run` for the
window:
  realtime  block k of the stream falls due at t0 + (k+1) * its length,
            whether or not block k-1 is done; each block goes through
            `Receiver.run`, its outputs come to the host and its rds_soft
            into `StreamingRdsDecoder.push`; lag = done - due
  closed    one step after another, as the CLI's `--stations` loop: the
            step's column range of every station gathered into one host
            block, `Receiver.run` on it (which moves it to the card), and
            the previous step drained (outputs to the host, rds_soft into
            `MultiStreamingRds.push`) once this one is enqueued
then one step more, compare with the reference (check.py) and print the
result line.  Spans (enqueue, gather, d2h, rds_push, wait_due) are the
harness's own clock around its calls into the program; with `--trace 1`
they are also `record_function` ranges in the torch.profiler trace of the
window, from which the per-layer metrics and the breakdown are read.

The antenna layout.  A traffic file with an `antenna` object puts all
its stations on one antenna stream, as a wideband receiver takes it:
  fs           the stream's rate, a whole multiple of the mode's RF rate
  offsets_hz   each station's offset from the stream's centre (one a
               station), each a whole number of turns over the buffer
  level_db     [lo, hi]: each station's level, drawn from the seed
  amplitude    the sum's share of u8 full scale
Station s plays programme s mod P, synthesized at `fs`, from a seeded
offset (a whole number of RF-rate samples); the sum is one (1, 2 n) u8
row (synth.antenna_stream), a step its columns.  The system's
`step_bytes(config, blocks_per_step, antenna=)` and `build(config,
blocks_per_step, device, antenna=)` then count the stream's bytes a
step; the reference's `build(config, k, precision=, device=, antenna=,
indices=)` channelizes the stations `indices` (the checked ones; every
one for the control) out of the stream steps it is fed.  A step is
step_bytes / 2 / fs seconds and K station-seconds of `decode_rate`; RDS
bits are counted in RF-rate samples.  Without `antenna` every module is
called as before and the bytes are the same.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark import check
from benchmark.peaks import roofline
from benchmark.reference.modes import MODES
from benchmark.traffic import synth

BENCH_DIR = Path(__file__).resolve().parent
SPAN_NAMES = ("enqueue", "gather", "d2h", "rds_push", "wait_due")
FORBIDDEN = ("jax", "jaxlib", "flax", "sdr_tpu")


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path

    def module(self, kind: str, name: str):
        """benchmark/<kind>/<name>.py, loaded by its path."""
        return _load(self.bench_dir / kind / f"{name}.py")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its data files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = root / BENCH_DIR.name
    return Cell(
        name=name, config_name=w["config"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((bench_dir / "traffic" /
                            f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        bench_dir=bench_dir)


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spans:
    """Total seconds and count of each harness span; with a profiler
    running, each span is also a `record_function` range."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.total = dict.fromkeys(SPAN_NAMES, 0.0)
        self.count = dict.fromkeys(SPAN_NAMES, 0)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = (torch.profiler.record_function(name) if self.traced
              else contextlib.nullcontext())
        t = time.perf_counter()
        with rf:
            yield
        self.total[name] += time.perf_counter() - t
        self.count[name] += 1


@dataclass
class Run:
    """What a per-layer metric's reader sees of a traced run."""
    cell: Cell
    steps: int                    # blocks (realtime) or steps in the window
    stations: int
    step_bytes: int
    spans: Spans
    device_events: list = field(default_factory=list)  # (cat, name, ts, dur)
    busy_s: float = 0.0
    traced_s: float = 0.0         # the window on the trace's clock

    def per_step_ms(self, seconds: float | None) -> float | None:
        if seconds is None or self.steps == 0:
            return None
        return seconds / self.steps * 1e3

    def span_ms(self, name: str) -> float | None:
        """Span total a step, where the span ran in the window."""
        if not self.spans.count[name]:
            return None
        return self.per_step_ms(self.spans.total[name])

    def device_s(self, cats=("kernel",), match=None) -> float | None:
        """Device seconds of the traced events of `cats` whose names
        `match` (a predicate); None with no such event."""
        durs = [d for c, n, _, d in self.device_events
                if c in cats and (match is None or match(n))]
        return sum(durs) * 1e-6 if durs else None

    def idle_pct(self) -> float | None:
        if not self.device_events or self.traced_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.traced_s)

    def work(self):
        """(bytes, ops) of one step by the configuration's work file."""
        return self.cell.module("work", self.cell.config_name).step_work(
            self.stations, self.step_bytes)

    def roofline_s(self) -> float:
        nbytes, ops = self.work()
        return roofline(nbytes, ops)[0]


def draw_checked(rng: np.random.Generator, stations: int, k: int) -> list:
    """k stations, one from each of k equal strata of the batch, even and
    odd in turns where a stratum allows: every half of the batch, the
    first or last or the even or odd stations, holds checked stations."""
    k = min(k, stations)
    edges = np.linspace(0, stations, k + 1).astype(int)
    out = []
    for j in range(k):
        lo, hi = edges[j], edges[j + 1]
        pick = [s for s in range(lo, hi) if s % 2 == j % 2] or \
            list(range(lo, hi))
        out.append(int(rng.choice(pick)))
    return out


@dataclass
class Traffic:
    buf: np.ndarray               # (stations, n) u8 in host memory
    programmes: list
    station_programme: list
    checked: list
    step_bytes: int
    step_s: float
    offsets: np.ndarray | None = None   # start in its programme (RF rate)
    n_bits: int = 0               # RDS bits in a loop of the buffer
    decim: int = 1                # stream samples an RF-rate sample

    def bit_spans(self, first: int, end: int) -> list:
        """Each station's stream bits [b0, b1) that stream steps [first,
        end) carry, counted from its programme's first loop (in RF-rate
        samples: `offsets` counts them)."""
        n_pairs = self.buf.shape[1] // 2 // self.decim
        half = self.step_bytes // 2 // self.decim
        return [((first * half + int(o)) * self.n_bits // n_pairs,
                 (end * half + int(o)) * self.n_bits // n_pairs)
                for o in self.offsets]

    @property
    def buffer_steps(self) -> int:
        return self.buf.shape[1] // self.step_bytes

    stage: np.ndarray | None = None

    def step(self, j: int, rows=None) -> np.ndarray:
        """Columns of stream step j (the buffer loops)."""
        j %= self.buffer_steps
        cols = slice(j * self.step_bytes, (j + 1) * self.step_bytes)
        return self.buf[:, cols] if rows is None else self.buf[rows, cols]

    def gather(self, j: int) -> np.ndarray:
        """Step j's columns of every station copied into one contiguous
        host block, the same block every step (as a fleet reader fills
        its read buffer): the copy is the read, with no allocation."""
        if self.stage is None:
            self.stage = np.zeros((self.buf.shape[0], self.step_bytes),
                                  np.uint8)
        np.copyto(self.stage, self.step(j))
        return self.stage


def antenna_turns(antenna: dict, stations: int, n: int, fs: int) -> list:
    """Each offset's whole turns over n stream samples at fs; raises where
    the layout does not hold (module doc)."""
    offs = antenna["offsets_hz"]
    if len(offs) != stations:
        raise ValueError(f"antenna: {len(offs)} offsets for {stations} "
                         "stations")
    turns = []
    for f in offs:
        if f != int(f) or int(f) * n % fs:
            raise ValueError(
                f"antenna: {f} Hz makes {f * n / fs} turns over the "
                f"buffer's {n} samples at {fs}: a looped buffer would not "
                "be one continuous broadcast")
        turns.append(int(f) * n // fs)
    return turns


def make_traffic(cell: Cell, step_bytes: int, seed: int,
                 device) -> Traffic:
    """The cell's broadcasts from the seed: `programmes` distinct ones,
    station s playing programme s mod P from a seeded offset; one row a
    station, or one antenna stream of them all (module doc)."""
    t = cell.traffic
    rf_fs = MODES[cell.config["mode"]].rf_fs
    ant, fs = t.get("antenna"), rf_fs
    if ant is not None:
        fs = int(ant["fs"])
        if fs != ant["fs"] or fs % rf_fs:
            raise ValueError(f"antenna: fs {ant['fs']} is no whole multiple "
                             f"of the RF rate {rf_fs}")
    step_s = step_bytes / 2 / fs
    buf_steps = max(1, round(t["buffer_seconds"] / step_s))
    n_pairs = buf_steps * step_bytes // 2
    rng = np.random.default_rng(seed % 2 ** 64)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    k = t["stations"]
    station_programme = [s % t["programmes"] for s in range(k)]
    if ant is None:
        progs, buf, offsets = station_rows(t, n_pairs, fs, station_programme,
                                           rng, gen, device)
    else:
        progs, buf, offsets = antenna_row(t, n_pairs, fs, fs // rf_fs,
                                          station_programme, rng, gen, device)
    checked = draw_checked(rng, k, t["check_stations"])
    return Traffic(buf, progs, station_programme, checked, step_bytes,
                   step_s, offsets, n_pairs * synth.SYMBOL_RATE // (2 * fs),
                   fs // rf_fs)


def station_rows(t: dict, n: int, fs: int, station_programme, rng, gen,
                 device):
    """(programmes, (stations, 2 n) u8, offsets): a row a station, each
    its programme's u8 from its offset (in pairs)."""
    progs = [synth.synthesize(n, fs, rng, t["signal"], gen, device)
             for _ in range(t["programmes"])]
    src = [p.u8.cpu().numpy() for p in progs]
    for p in progs:
        p.u8 = None
    k = len(station_programme)
    buf = np.empty((k, 2 * n), np.uint8)
    offsets = 2 * rng.integers(0, n, k)
    for s in range(k):
        o, row = int(offsets[s]), src[station_programme[s]]
        buf[s, :row.size - o] = row[o:]
        buf[s, row.size - o:] = row[:o]
    return progs, buf, offsets // 2


def antenna_row(t: dict, n: int, fs: int, decim: int, station_programme,
                rng, gen, device):
    """(programmes, (1, 2 n) u8, offsets): the stations on one antenna
    stream at fs (module doc), each from its offset (in RF-rate samples,
    decim stream samples each)."""
    ant = t["antenna"]
    if n % decim:
        raise ValueError(f"antenna: {n} samples a loop are no whole number "
                         f"of RF-rate samples")
    k = len(station_programme)
    turns = antenna_turns(ant, k, n, fs)
    made = [synth.baseband(n, fs, rng, t["signal"], device)
            for _ in range(t["programmes"])]
    offsets = rng.integers(0, n // decim, k)
    gains = 10 ** (rng.uniform(*ant["level_db"], k) / 20)
    sigma = 10 ** (rng.uniform(*t["signal"]["noise_db"]) / 20)
    u8 = synth.antenna_stream([z for _, z in made], station_programme,
                              offsets * decim, turns, gains, sigma,
                              ant["amplitude"], gen)
    return [p for p, _ in made], u8.cpu().numpy()[None], offsets


class Control:
    """The reference computed one format below the configuration's stated
    precision, in the program's place (the comparison's control)."""

    def __init__(self, cell: Cell, stations: int, device):
        c = cell.config
        ref = cell.module("reference", c["reference"])
        self.ref = ref.build(c, stations, precision=ref.lower(c["precision"]),
                             device=device,
                             **antenna_args(cell, range(stations)))

    def step(self, u8: torch.Tensor) -> dict:
        return self.ref.process(u8)

    def free(self):
        self.ref = None


def wait_until(t: float) -> None:
    """Spin on the clock until t.  A sleeper hands its core back, and on
    a shared host it wakes late and on a cold core: the block it then
    serves pays for that in its lag, by how busy the neighbours are."""
    while time.perf_counter() < t:
        pass


class Sink:
    """The host side of a step: outputs to the host, the checked stations'
    rows kept for the comparison, rds_soft into the program's decoders."""

    def __init__(self, keys, checked, decoders, spans: Spans):
        self.keys, self.checked, self.spans = keys, checked, spans
        self.decoders = decoders          # None, or push(np (k, n))
        self.kept = {k: [] for k in keys}

    def __call__(self, out: dict) -> None:
        """An output the step lacks is kept as nothing (the comparison
        then finds it short)."""
        with self.spans("d2h"):
            host = {k: out[k].float().cpu().numpy() for k in self.keys
                    if k in out}
        for k, v in host.items():
            self.kept[k].append(v[self.checked])
        if self.decoders is not None and "rds_soft" in host:
            with self.spans("rds_push"):
                self.decoders(host["rds_soft"])

    def lengths(self) -> dict:
        return {k: sum(a.shape[-1] for a in v) for k, v in self.kept.items()}

    def joined(self) -> dict:
        return {k: np.concatenate(v, axis=-1).astype(np.float64)
                for k, v in self.kept.items() if v}


def realtime_window(system, traffic: Traffic, first: int, seconds: float,
                    spans: Spans, sink: Sink, late: list | None = None,
                    parts: list | None = None):
    """Open loop: block k due at t0 + (k+1) step_s; returns (lags of the
    blocks due in the window, each min(done, t_end) - due; t0; t_done).
    `late` collects how late each block started (the generator's wait
    for the host), `parts` each block's (enqueue, sink) seconds."""
    t0 = time.perf_counter()
    t_end = t0 + seconds
    lags, k = [], 0
    late = [] if late is None else late
    while True:
        due = t0 + (k + 1) * traffic.step_s
        if due > t_end:
            break
        with spans("wait_due"):
            wait_until(due)
        blk = torch.from_numpy(traffic.step(first + k))
        late.append(time.perf_counter() - due)
        t_in = time.perf_counter()
        with spans("enqueue"):
            out = system.step(blk)
        t_enq = time.perf_counter()
        sink(out)
        t_out = time.perf_counter()
        lags.append(min(t_out, t_end) - due)
        if parts is not None:
            parts.append((t_enq - t_in, t_out - t_enq))
        k += 1
    return lags, t0, time.perf_counter()


def closed_window(system, traffic: Traffic, first: int, seconds: float,
                  spans: Spans, sink: Sink, drained: list | None = None):
    """Closed loop, step k+1 enqueued before step k drains; returns
    (steps, t0, t_done), t_done once the last step has drained.
    `drained` collects the time each step had drained."""
    t0 = time.perf_counter()
    end = t0 + seconds
    steps, pending = 0, None
    drained = [] if drained is None else drained
    while time.perf_counter() < end:
        with spans("gather"):
            blk = torch.from_numpy(traffic.gather(first + steps))
        with spans("enqueue"):
            out = system.step(blk)
        if pending is not None:
            sink(pending)
            drained.append(time.perf_counter())
        pending, steps = out, steps + 1
    sink(pending)
    drained.append(time.perf_counter())
    return steps, t0, drained[-1]


def antenna_args(cell: Cell, indices=None) -> dict:
    """The keywords a module of an antenna cell takes besides the usual
    ones (module doc): the layout, and for the reference the `indices` of
    its stations; none for a cell of one row a station."""
    ant = cell.traffic.get("antenna")
    if ant is None:
        return {}
    return {"antenna": ant} if indices is None else {
        "antenna": ant, "indices": [int(i) for i in indices]}


def reference_outputs(cell: Cell, traffic: Traffic, n_steps: int, keys,
                      device, chunk_bytes: int = 1 << 22) -> dict:
    """The reference over the checked stations' first n_steps stream
    steps, a chunk of whole steps at a time; float64 on the host.  It is
    fed the checked stations' rows, or the antenna stream's steps."""
    c = cell.config
    ref = cell.module("reference", c["reference"]).build(
        c, len(traffic.checked), device=device,
        **antenna_args(cell, traffic.checked))
    rows = None if "antenna" in cell.traffic else traffic.checked
    per = max(1, chunk_bytes // traffic.step_bytes)
    outs = {k: [] for k in keys}
    for j in range(0, n_steps, per):
        u8 = np.concatenate([traffic.step(s, rows)
                             for s in range(j, min(j + per, n_steps))],
                            axis=-1)
        o = ref.process(torch.from_numpy(u8).to(device))
        for k in keys:
            outs[k].append(o[k].cpu().numpy())
    return {k: np.concatenate(v, axis=-1) for k, v in outs.items()}


def read_trace(prof) -> tuple[list, list]:
    """(device events (cat, name, ts_us, dur_us), harness spans (name,
    ts_us, dur_us)) from the profiler's trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((cat, e["name"], float(e["ts"]), float(e["dur"])))
        elif cat == "user_annotation" and e.get("name") in SPAN_NAMES:
            host.append((e["name"], float(e["ts"]), float(e["dur"])))
    return dev, host


def busy_and_gaps(dev: list, host: list) -> tuple[float, float, list]:
    """(busy_s, traced_s, gaps): the union of device activity within the
    window (first to last harness span), the window's length on the
    trace's clock, and the idle gaps (start_us, dur_us, what the host was
    doing: the innermost harness span over the gap's middle, or 'host')."""
    if not host:
        return 0.0, 0.0, []
    lo = min(t for _, t, _ in host)
    hi = max(t + d for _, t, d in host)
    iv = sorted((max(t, lo), min(t + d, hi)) for _, _, t, d in dev
                if t + d > lo and t < hi)
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            over = [(d, n) for n, t, d in host if t <= mid <= t + d]
            gaps.append((a, b - a, min(over)[1] if over else "host"))
    return busy * 1e-6, (hi - lo) * 1e-6, gaps


def breakdown(dev: list, gaps: list) -> dict:
    """The 10 device operations that took most time, and the 10 longest
    idle gaps by what the host was doing (seconds)."""
    by_name: dict = {}
    for _, n, _, d in dev:
        by_name[n] = by_name.get(n, 0.0) + d * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps, key=lambda g: -g[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, d * 1e-6] for _, d, n in longest]}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def fence(device, what: str) -> None:
    """Wait for the device; an asynchronous fault raises here, named by
    the phase that launched it."""
    if device.type != "cuda":
        return
    try:
        torch.cuda.synchronize(device)
    except RuntimeError as e:
        raise RuntimeError(f"device fault during {what}: {e}") from e


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, t_start: float, device="cuda",
             system: str = "program") -> dict:
    """One run of `workload`; returns the result line's object (with
    `notes`, numbers for the log only)."""
    device = torch.device(device)
    cell = load_cell(root, workload)
    conf, t = cell.config, cell.traffic
    bps = t["blocks_per_step"]
    system_mod = cell.module("systems", conf["system"])
    # the broadcasts before the program: the synthesis' own kernels run on
    # a device that nothing else has touched yet, and a fault the
    # program's set-up leaves pending surfaces at the fence below it
    ant = antenna_args(cell)
    traffic = make_traffic(cell, system_mod.step_bytes(conf, bps, **ant),
                           seed, device)
    fence(device, "synthesis of the broadcasts")
    prog = system_mod.build(conf, bps, device, **ant)
    fence(device, "building the system")
    k = t["stations"]
    keys = list(conf["outputs"])
    spans = Spans()
    decoders, push = None, None
    if "rds_soft" in keys and t["rds_decode"]:
        decoders, push = prog.rds_decoders(k, t["loop"] == "realtime")
    sink = Sink(keys, traffic.checked, push, spans)
    sys_ = prog if system == "program" else Control(cell, k, device)

    def one_step(j):
        sink(sys_.step(torch.from_numpy(traffic.gather(j))))

    # warm-up: every shape the window uses, and the decoders synced
    warm = t["warmup"]
    done = 0
    while done < warm["max_steps"] and (
            done < warm["min_steps"] or (
                warm.get("until_rds_sync") and decoders is not None
                and any(d.info.pi is None for d in decoders))):
        one_step(done)
        done += 1
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):        # sets CUPTI up, untimed
            one_step(done)
            done += 1
        prof = profile(activities=acts)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    first = done
    groups0 = ([len(d.groups) for d in decoders] if decoders is not None
               else None)
    spans_w = Spans(traced=trace)
    sink.spans = spans_w
    late: list = []
    parts: list = []
    drained: list = []
    if prof is not None:
        prof.__enter__()
    try:
        if t["loop"] == "realtime":
            res, t0, t_done = realtime_window(sys_, traffic, done, seconds,
                                              spans_w, sink, late, parts)
        else:
            res, t0, t_done = closed_window(sys_, traffic, done, seconds,
                                            spans_w, sink, drained)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    setup_s = t0 - t_start
    n_win = len(res) if isinstance(res, list) else res
    done += n_win
    # one step after the window, from the state it left
    sink.spans = Spans()
    cont_start = sink.lengths()
    one_step(done)
    done += 1
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    sys_.free()
    prog.free()
    del prog, sys_
    if device.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    if isinstance(res, list):
        values = {"lag_p95_ms": float(np.percentile(res, 95)) * 1e3}
        attempted = len(res)
        fifth = len(res) // 5
        notes = {"lag_p50_ms": float(np.percentile(res, 50)) * 1e3,
                 "start_late_p95_ms": float(np.percentile(late, 95)) * 1e3,
                 "enqueue_p50_p95_ms": [float(x) * 1e3 for x in np.percentile(
                     [a for a, _ in parts], [50, 95])],
                 "sink_p50_p95_ms": [float(x) * 1e3 for x in np.percentile(
                     [b for _, b in parts], [50, 95])]}
        if fifth:
            notes["lag_p95_ms_by_fifth"] = [
                float(np.percentile(res[i:i + fifth], 95)) * 1e3
                for i in range(0, fifth * 5, fifth)]
    else:
        values = {"decode_rate": n_win * k * traffic.step_s
                  / (t_done - t0)}
        attempted = n_win * k
        notes = {"steps": n_win, "window_s": t_done - t0}
        if n_win >= 5:
            marks = [t0] + drained
            idx = [round(i * n_win / 5) for i in range(6)]
            notes["decode_rate_by_fifth"] = [
                (j - i) * k * traffic.step_s / (marks[j] - marks[i])
                for i, j in zip(idx, idx[1:])]
    values["setup_s"] = setup_s
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": attempted, "failed": 0}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        dev, host = read_trace(prof)
        busy, traced_s, gaps = busy_and_gaps(dev, host)
        run = Run(cell, n_win, k, traffic.step_bytes, spans_w, dev, busy,
                  traced_s)
        for m in cell.per_layer:
            v = cell.module("metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if dev:
            dev_info.update(busy_s=busy, window_s=traced_s)
            result["breakdown"] = breakdown(dev, gaps)

    # the comparison, after the window, with the program's state freed
    outs = sink.joined()
    ref = reference_outputs(cell, traffic, done, keys, device)
    nums = check.gaps(outs, ref, keys)
    nums["state_gap"] = check.worst(check.gaps(outs, ref, keys,
                                               start=cont_start).values())
    if decoders is not None:
        nums.update(check.rds_numbers(decoders, traffic.programmes,
                                      traffic.station_programme))
        got = [len(d.groups) - g for d, g in zip(decoders, groups0)]
        bit_spans = traffic.bit_spans(first, done)
        n_groups = len(traffic.programmes[0].groups)
        nums["rds_groups_missed"], margin = check.groups_missed(
            got, bit_spans, traffic.n_bits, n_groups)
        notes["rds_groups_margin"] = margin
        notes["rds_groups_decoded_min"] = min(got)
        notes["rds_seams_max"] = max(
            check.seams_crossed(b0, b1, traffic.n_bits, n_groups)
            for b0, b1 in bit_spans)
    ok, table = check.judge(nums, conf["limits"])
    result.update(correct=ok, metrics=metrics, device=dev_info)
    result["notes"] = notes
    result["compared"] = table
    return result
