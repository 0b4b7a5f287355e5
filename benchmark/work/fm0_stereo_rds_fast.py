"""Work of one step of the mode-0 stereo + RDS receiver, stage by stage,
from the shapes alone: whatever implements a stage, its work is this.

Bytes: the step's u8 block read once and its outputs (mono, left, right
and rds_soft, float32) written once; what a chain of stages passes between
them is not counted, so the bound holds for any fusion.  Operations: a
multiply and an add for each FIR tap of each output it keeps, in the
precision the configuration states (the front end's int8, the rest bf16),
and the float32 arithmetic of the discriminator (9 a sample), the
squaring, the carrier estimators' mix sums (4 a sample and carrier), the
NCO synthesis (10 a sample and carrier), the mixers (2) and the stereo
matrix (4 an audio sample).  Frozen from chip_smoke.py `kernel_work`'s
counts at commit c6f277a, summed over the chain.
"""

RF_DECIM, AUDIO_DECIM, TAPS = 10, 5, 51
RDS_UP, RDS_DOWN, RRC_TAPS = 19, 120, 151


def step_work(stations: int, step_bytes: int):
    m = step_bytes // (2 * RF_DECIM)            # IF samples a station
    a = m // AUDIO_DECIM                        # audio samples
    r = m * RDS_UP // RDS_DOWN                  # RDS samples
    ops = {
        "int8": 2 * m * TAPS * 2,               # I and Q channel filter
        "bf16": (4 * m * TAPS * 2               # IF bank: 4 band-passes
                 + 2 * a * TAPS * 2             # audio pair
                 + r * TAPS * 2                 # RDS resampler, 969/19
                 + r * RRC_TAPS * 2),           # RRC
        "f32": (9 * m + m + 2 * 4 * m + 2 * 10 * m + 2 * 2 * m
                + 4 * a),
    }
    nbytes = step_bytes + (3 * a + r) * 4
    return stations * nbytes, {t: stations * n for t, n in ops.items()}
