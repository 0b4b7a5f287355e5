"""The comparison that decides `correct`.

What the timed path delivered to the host for the checked stations (every
step from the first warm-up step through the window and one step after
it) against the plain reference (reference/receiver.py) run over the same
bytes after the window:

  audio_gap     max |program - reference| / max |reference| over left and
                right, the worst checked station
  rds_soft_gap  the same for the RDS matched-filter output, each station's
                reference taken at the sign that fits it: BPSK recovered
                from the squared carrier is defined up to its polarity,
                which the differential code resolves downstream
  state_gap     both measures over the step after the window alone: it
                starts from the state the window left, so it judges that
                state by what it produces
  rds_wrong_groups   decoded groups of any station that its broadcast
                     never sent (exact: limit 0)
  rds_pi_ps_wrong    stations whose decoded PI or PS differs from the
                     broadcast's (exact: limit 0)
  rds_groups_missed  the worst station's groups sent and not decoded from
                     the window's start through the step after it: the
                     whole groups its stream carried there, but for
                     SLACK_GROUPS at each end (the chain's and the
                     decoder's delay), less the groups it decoded, and 0
                     where it decoded as many or more; every station, not
                     only the checked ones (exact: limit 0)

A gap that is not finite (a NaN or an infinity in the program's output),
or an output missing or of another length, reads infinite and fails.

Each limit is the configuration's (`limits` in its file), set between the
program's readings and the control's; PERF.md gives the readings.
"""

from __future__ import annotations

import numpy as np

# groups at each end of a span not held against the decoder: the chain's
# filters and the decoder's search hold back up to about one group
SLACK_GROUPS = 2


def _gap(prog: np.ndarray, ref: np.ndarray, sign_free: bool) -> float:
    """Worst station's max |prog - ref| / max |ref| (rows are stations);
    infinite where the program's row holds a value that is not finite."""
    worst = 0.0
    for p, r in zip(prog, ref):
        if not np.all(np.isfinite(p)):
            return float("inf")
        scale = max(float(np.max(np.abs(r))), 1e-30)
        err = float(np.max(np.abs(p - r)))
        if sign_free:
            err = min(err, float(np.max(np.abs(p + r))))
        worst = max(worst, err / scale)
    return worst


def gaps(prog: dict, ref: dict, keys, start: dict | None = None) -> dict:
    """{'audio_gap', 'rds_soft_gap'} over outputs from column `start[key]`
    on (0 by default); infinite where the program's output is missing,
    has another length or holds a value that is not finite."""
    out = {}
    for name, ks in (("audio_gap", [k for k in keys if k != "rds_soft"]),
                     ("rds_soft_gap", [k for k in keys if k == "rds_soft"])):
        if not ks:
            continue
        vals = []
        for k in ks:
            s = (start or {}).get(k, 0)
            p, r = prog.get(k), ref[k][:, s:]
            if p is None or p[:, s:].shape != r.shape:
                vals.append(float("inf"))
                continue
            vals.append(_gap(p[:, s:], r, sign_free=(k == "rds_soft")))
        out[name] = worst(vals)
    return out


def worst(vals) -> float:
    """The largest of `vals`, NaN if any is NaN (Python's max drops a NaN
    that is not first)."""
    return float(np.max(np.asarray(list(vals), np.float64)))


def rds_numbers(decoders, programmes, station_programme) -> dict:
    """Decoded groups and station info against what each station's
    broadcast sent."""
    wrong_groups = wrong_info = 0
    for s, dec in enumerate(decoders):
        prog = programmes[station_programme[s]]
        sent = set(prog.groups)
        wrong_groups += sum(tuple(g.blocks) not in sent for g in dec.groups)
        info = dec.info
        wrong_info += int(info.pi != prog.pi or info.ps_name != prog.ps)
    return {"rds_wrong_groups": wrong_groups, "rds_pi_ps_wrong": wrong_info}


def groups_carried(b0: int, b1: int, n_bits: int, n_groups: int) -> int:
    """Whole groups in the bits [b0, b1) of a looped stream whose loop of
    n_bits bits carries n_groups groups of 104 bits from its start (the
    rest of the loop is no group); b0 and b1 count bits from the first
    loop's start and may lie in any later loop."""
    def ended_by(b):        # groups whose last bit lies before bit b
        loops, rem = divmod(b, n_bits)
        return loops * n_groups + min(rem // 104, n_groups)

    def started_by(b):      # groups whose first bit lies before bit b
        loops, rem = divmod(b, n_bits)
        return loops * n_groups + min(-(-rem // 104), n_groups)

    return max(0, ended_by(b1) - started_by(b0))


def seams_crossed(b0: int, b1: int, n_bits: int, n_groups: int) -> int:
    """Loop starts inside (b0, b1) where the loop is not whole groups (the
    decoder loses lock there and relocks on the next group, which on the
    card cost no group: PERF.md)."""
    if n_bits == 104 * n_groups or b1 <= b0:
        return 0
    return (b1 - 1) // n_bits - b0 // n_bits


def groups_missed(decoded: list, spans: list, n_bits: int,
                  n_groups: int) -> tuple[int, int]:
    """(missed, margin): the worst station's groups carried and not
    decoded, at least 0, and the least of (decoded - carried) over the
    stations; carried = the whole groups in the station's span of stream
    bits (`spans[s]` = (b0, b1)) but for SLACK_GROUPS at each end, decoded
    = the groups it decoded over the span (`decoded[s]`)."""
    slack = 104 * SLACK_GROUPS
    margin = min(got - groups_carried(b0 + slack, b1 - slack, n_bits,
                                      n_groups)
                 for got, (b0, b1) in zip(decoded, spans))
    return max(0, -margin), margin


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {'value', 'limit'}}): each number at or under its
    limit; a NaN fails (it compares False), as does a number the
    configuration gives no limit."""
    table = {}
    ok = True
    for name, v in values.items():
        lim = limits.get(name)
        table[name] = {"value": v, "limit": lim}
        ok = ok and lim is not None and bool(v <= lim)   # NaN: False
    return ok, table
