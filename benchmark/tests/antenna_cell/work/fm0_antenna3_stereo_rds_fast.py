"""Work of one step of the wideband stereo + RDS receiver, stage by
stage, from the shapes alone: whatever implements a stage, its work is
this.

Bytes: the stream's u8 step read once and each station's outputs (mono,
left, right and rds_soft, float32) written once.  Operations: the
channelizer's complex filter (a complex multiply and add, 8 operations,
for each tap of each output it keeps, in bf16 as the configuration
states) and its rotation (6 a sample, float32); then a station's chain as
in fm0_stereo_rds_fast's work, all in float32 (the unfused front end, the
band-passes, the resamplers and the RRC as FIRs).
"""

DECIM, CHANNEL_TAPS = 4, 101          # 9.6 MS/s to the 2.4 MS/s RF rate
RF_DECIM, AUDIO_DECIM, TAPS = 10, 5, 51
RDS_UP, RDS_DOWN, RRC_TAPS = 19, 120, 151


def step_work(stations: int, step_bytes: int):
    n = step_bytes // (2 * DECIM)               # RF samples a station
    m = n // RF_DECIM                           # IF samples
    a = m // AUDIO_DECIM                        # audio samples
    r = m * RDS_UP // RDS_DOWN                  # RDS samples
    ops = {
        "bf16": n * CHANNEL_TAPS * 8,
        "f32": (6 * n
                + 2 * m * TAPS * 2              # I and Q channel filter
                + 4 * m * TAPS * 2              # the four band-passes
                + 2 * a * TAPS * 2              # audio pair
                + r * TAPS * 2 + r * RRC_TAPS * 2
                + 9 * m + m + 2 * 4 * m + 2 * 10 * m + 2 * 2 * m
                + 4 * a),
    }
    nbytes = step_bytes + stations * (3 * a + r) * 4
    return nbytes, {t: stations * v for t, v in ops.items()}
