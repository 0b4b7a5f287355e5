"""Work of one step of the mode-0 stereo receiver (no RDS), stage by
stage, from the shapes alone: whatever implements a stage, its work is
this.

Bytes: the step's u8 block read once and its outputs (mono, left, right,
float32) written once; what a chain of stages passes between them is not
counted, so the bound holds for any fusion.  Operations: a multiply and an
add for each FIR tap of each output it keeps, in bf16 as the
configuration states, and the float32 arithmetic of the discriminator (9
a sample), the pilot estimator's mix sums (4 a sample), its NCO synthesis
(10), the mixer (2) and the stereo matrix (4 an audio sample).  Frozen
from chip_smoke.py `kernel_work`'s counts at commit c6f277a, summed over
the chain.
"""

RF_DECIM, AUDIO_DECIM, TAPS = 10, 5, 51


def step_work(stations: int, step_bytes: int):
    m = step_bytes // (2 * RF_DECIM)            # IF samples a station
    a = m // AUDIO_DECIM                        # audio samples
    ops = {
        "bf16": (2 * m * TAPS * 2               # I and Q channel filter
                 + 2 * m * TAPS * 2             # channel and pilot BPFs
                 + 2 * a * TAPS * 2),           # audio pair
        "f32": 9 * m + 4 * m + 10 * m + 2 * m + 4 * a,
    }
    nbytes = step_bytes + 3 * a * 4
    return stations * nbytes, {t: stations * n for t, n in ops.items()}
