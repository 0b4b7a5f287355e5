"""The port's CLI taps and checkpoint flags against sdr_tpu's, in-process
on the same short captures (the port with --device cpu): --save-state /
--resume, --psd-dump, --psd-anim, --trace-iq, --profile and the host
I/O that --stats names; the Fourier helpers behind the PSDs."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu import cli as jcli
from sdr_tpu.ops import fourier as jfourier
from sdr_tpu_torch import cli as tcli
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.ops import fourier
from sdr_tpu_torch.rds import tx as rds_tx


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    """0.4 s captures: mono 1 kHz, and stereo L 1 kHz / R 2.5 kHz with RDS
    PI 0x3d44."""
    cfg = MODES[0]
    n = int(0.4 * cfg.rf_fs)
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="TPU FM  ",
                                        n_groups=8)
    d = tmp_path_factory.mktemp("aux")
    out = {}
    for name, kw in (("mono", dict(mono=tx.tone(cfg.rf_fs, 1000.0, n))),
                     ("stereo", dict(
                         left=tx.tone(cfg.rf_fs, 1000.0, n),
                         right=tx.tone(cfg.rf_fs, 2500.0, n),
                         rds_baseband=rds_tx.bits_to_baseband(
                             bits, cfg.rf_fs)[:n], a_rds=0.1))):
        cap = tx.synthesize_capture(cfg, seconds=0.4, **kw)
        out[name] = cap
        cap.tofile(d / f"{name}.u8")
        out[name + "_path"] = str(d / f"{name}.u8")
    return out


def read_dat(path):
    return np.loadtxt(path, comments="#")


def test_parser_takes_every_reference_flag():
    """The port's CLI accepts every option of the reference's, with the
    same defaults, plus its own --device."""
    ref = {a.dest: a.default for a in jcli.build_parser()._actions}
    port = {a.dest: a.default for a in tcli.build_parser()._actions}
    assert set(port) - set(ref) == {"device"}
    assert {k: port[k] for k in ref} == ref


# --------------------------------------------------- --save-state / --resume
@pytest.mark.parametrize("flags", [["0", "1"], ["0", "2", "--rds", "--fast"]],
                         ids=["mono", "stereo_rds_fast"])
def test_save_state_then_resume_equals_one_run(caps, tmp_path, flags):
    """The capture cut at a step boundary into two CLI runs, the first
    saving its state and the second resuming it: the joined audio equals
    one uninterrupted run bit for bit, in the port as in the reference."""
    from sdr_tpu_torch.models.receiver import Receiver
    cap = caps["stereo" if "2" in flags else "mono"]
    fast = "--fast" in flags
    rx = Receiver(0, stereo="2" in flags, rds="--rds" in flags,
                  device="cpu", **(dict(
                      fused_frontend="int8", pll_impl="ff",
                      conv_dtype="bf16", conv_engine="tiled",
                      fused_ifbank="bf16") if fast else {}))
    bs = rx.block_size_u8(2)
    half = len(cap) // 2 // bs * bs
    a, b, whole = (tmp_path / f"{n}.u8" for n in ("a", "b", "whole"))
    cap[:half].tofile(a)
    cap[half:].tofile(b)
    cap.tofile(whole)
    common = [*flags, "--blocks-per-step", "2"]
    for pkg, extra in ((tcli, ["--device", "cpu"]), (jcli, [])):
        tag = pkg.__name__.split(".")[0]
        state = str(tmp_path / f"{tag}.npz")
        outs = {n: str(tmp_path / f"{tag}_{n}.raw")
                for n in ("a", "b", "whole")}
        assert pkg.main([*common, "--in", str(a), "--out", outs["a"],
                         "--save-state", state, *extra]) == 0
        assert pkg.main([*common, "--in", str(b), "--out", outs["b"],
                         "--resume", state, *extra]) == 0
        assert pkg.main([*common, "--in", str(whole), "--out", outs["whole"],
                         *extra]) == 0
        joined = np.concatenate([np.fromfile(outs[n], "<i2")
                                 for n in ("a", "b")])
        np.testing.assert_array_equal(joined,
                                      np.fromfile(outs["whole"], "<i2"))


def test_port_resumes_reference_checkpoint(caps, tmp_path, capsys):
    """The reference's --save-state file, resumed by the port's CLI: the
    joined stream equals the reference's one run within one LSB (the
    float32 default profile)."""
    from sdr_tpu_torch.models.receiver import Receiver
    cap = caps["mono"]
    bs = Receiver(0, device="cpu").block_size_u8(2)
    half = len(cap) // 2 // bs * bs
    a, b, whole = (tmp_path / f"{n}.u8" for n in ("a", "b", "whole"))
    cap[:half].tofile(a)
    cap[half:].tofile(b)
    cap.tofile(whole)
    state = str(tmp_path / "ref.npz")
    common = ["0", "1", "--blocks-per-step", "2"]
    assert jcli.main([*common, "--in", str(a), "--out",
                      str(tmp_path / "ja.raw"), "--save-state", state]) == 0
    assert jcli.main([*common, "--in", str(whole), "--out",
                      str(tmp_path / "jw.raw")]) == 0
    assert tcli.main([*common, "--in", str(b), "--out",
                      str(tmp_path / "tb.raw"), "--resume", state,
                      "--device", "cpu"]) == 0
    assert f"Resumed state from {state}" in capsys.readouterr().err
    joined = np.concatenate([np.fromfile(tmp_path / "ja.raw", "<i2"),
                             np.fromfile(tmp_path / "tb.raw", "<i2")])
    want = np.fromfile(tmp_path / "jw.raw", "<i2")
    assert joined.shape == want.shape
    assert np.abs(joined.astype(int) - want).max() <= 1


def test_resume_refuses_another_profile(caps, tmp_path):
    """A mono checkpoint does not load into the stereo receiver."""
    state = str(tmp_path / "mono.npz")
    assert tcli.main(["0", "1", "--in", caps["mono_path"], "--out",
                      str(tmp_path / "o.raw"), "--save-state", state,
                      "--device", "cpu"]) == 0
    with pytest.raises(ValueError, match="structure mismatch"):
        tcli.main(["0", "2", "--in", caps["mono_path"], "--out",
                   str(tmp_path / "p.raw"), "--resume", state,
                   "--device", "cpu"])


# ------------------------------------------------------------------ taps
def run_both(argv, tmp_path, cap_path):
    for pkg, tag, extra in ((jcli, "j", []), (tcli, "t", ["--device",
                                                          "cpu"])):
        args = [a.replace("BASE", str(tmp_path / tag)) for a in argv]
        assert pkg.main([*args, "--in", cap_path, "--out",
                         str(tmp_path / f"{tag}.raw"), *extra]) == 0


def assert_psd_close(got, want):
    """Frequencies equal; dB values within 1e-3 where the PSD is above
    -100 dB."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    live = want[:, 1] > -100.0
    assert live.mean() > 0.5
    assert np.abs(got[live, 1] - want[live, 1]).max() <= 1e-3


@pytest.mark.parametrize("flags", [["0", "1"], ["0", "2", "--fast"]],
                         ids=["mono", "stereo_fast"])
def test_psd_dump_matches_reference(caps, tmp_path, flags):
    run_both([*flags, "--psd-dump", "BASE_psd"], tmp_path,
             caps["stereo_path"])
    got = read_dat(tmp_path / "t_psd.dat")
    assert_psd_close(got, read_dat(tmp_path / "j_psd.dat"))
    assert got.shape == (256, 2)
    # the 19 kHz pilot stands out of the spectrum
    pilot = got[np.argmin(np.abs(got[:, 0] - 19.0)), 1]
    assert pilot > np.median(got[:, 1]) + 20.0


def test_psd_anim_matches_reference(caps, tmp_path):
    run_both(["0", "2", "--psd-anim", "BASE_anim", "--psd-anim-every", "3"],
             tmp_path, caps["stereo_path"])
    texts = [(tmp_path / f"{t}_anim.dat").read_text() for t in "jt"]
    frames = [t.split("# frame ")[1:] for t in texts]
    assert len(frames[0]) == len(frames[1]) > 3
    for jf, tf in zip(*frames):
        assert jf.splitlines()[0] == tf.splitlines()[0]
        assert_psd_close(np.loadtxt(tf.splitlines()[1:]),
                         np.loadtxt(jf.splitlines()[1:]))


def test_trace_iq_matches_reference(caps, tmp_path):
    """The four traces: the raw I/Q as text equal to the reference's, the
    filtered I/Q within 1e-6 (plus the 5-decimal print quantum)."""
    run_both(["0", "1", "--trace-iq", "BASE"], tmp_path, caps["mono_path"])
    for name in ("i_time", "q_time", "i_filt_time", "q_filt_time"):
        got = read_dat(tmp_path / f"t_{name}.dat")
        want = read_dat(tmp_path / f"j_{name}.dat")
        assert got.shape == want.shape == (512, 2)
        if "filt" in name:
            assert np.abs(got - want).max() <= 1e-6 + 1e-5
        else:
            assert ((tmp_path / f"t_{name}.dat").read_text()
                    == (tmp_path / f"j_{name}.dat").read_text())


def test_profile_writes_trace_with_stage_names(caps, tmp_path, capsys):
    """--profile writes a Chrome trace holding the receiver's ranges."""
    d = tmp_path / "prof"
    assert tcli.main(["0", "2", "--rds", "--fast", "--in",
                      caps["stereo_path"], "--out", str(tmp_path / "o.raw"),
                      "--profile", str(d), "--device", "cpu"]) == 0
    assert f"Wrote profiler trace to {d / 'trace.json'}" in (
        capsys.readouterr().err)
    names = {e.get("name") for e in json.loads(
        (d / "trace.json").read_text())["traceEvents"]}
    for scope in ("rf_frontend", "ifbank_fused_mix", "carrier_ffmix",
                  "audio_pair_kernel"):
        assert scope in names, scope


def test_named_scope_opens_a_range_only_under_the_profiler():
    """The receivers' ranges cost a null context with no profiler
    running, and are record_function ranges while one records."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from sdr_tpu_torch.io.logger import stage_scope
    assert not isinstance(stage_scope("demod"), record_function)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stage_scope("demod"):
            torch.zeros(4).sum()
    assert "demod" in {e.key for e in prof.key_averages()}


def test_stats_names_the_host_io(caps, tmp_path, capsys, monkeypatch):
    """--stats says which reader and sink ran: the native ring where it
    builds (with g++ on the host), the synchronous ones where it does
    not; both write the same stream."""
    from sdr_tpu_torch import native
    outs = {}
    for which in ("native", "sync"):
        if which == "sync":
            monkeypatch.setattr(native, "available", lambda: False)
        out = tmp_path / f"{which}.raw"
        assert tcli.main(["0", "1", "--in", caps["mono_path"], "--out",
                          str(out), "--stats", "--device", "cpu"]) == 0
        assert (f"host I/O: {which} reader, {which} sink"
                in capsys.readouterr().err)
        outs[which] = out.read_bytes()
    assert outs["native"] == outs["sync"] and len(outs["sync"]) > 0


# ------------------------------------------------------------- ops/fourier
def test_dft_idft_roundtrip():
    x = np.random.default_rng(1234).standard_normal(64).astype(np.float32)
    got = fourier.idft(fourier.dft(torch.from_numpy(x))).real.numpy()
    np.testing.assert_allclose(got, x, atol=1e-4)


def test_dft_fft_and_magnitude_match_reference():
    x = np.random.default_rng(7).standard_normal((2, 128)).astype(
        np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(fourier.dft(t).numpy(),
                               fourier.fft(t).numpy(), rtol=1e-3, atol=1e-3)
    for name in ("dft", "fft"):
        want = np.asarray(getattr(jfourier, name)(jnp.asarray(x)))
        got = getattr(fourier, name)(t).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    xf = fourier.fft(t)
    np.testing.assert_allclose(fourier.ifft(xf).real.numpy(), x, atol=1e-5)
    np.testing.assert_allclose(
        fourier.vector_magnitude(xf).numpy(),
        np.asarray(jfourier.vector_magnitude(jnp.asarray(xf.numpy()))),
        rtol=1e-6)


@pytest.mark.parametrize("nfft,fs", [(512, 48000.0), (256, 240000.0)])
def test_estimate_psd_matches_reference(nfft, fs):
    """Hann window, scaling and dB as the reference's; the tone's bin
    peaks."""
    t = np.arange(8192) / fs
    x = (np.sin(2 * np.pi * 6000.0 * t)
         + 0.01 * np.random.default_rng(3).standard_normal(8192)
         ).astype(np.float32)
    freq, psd = fourier.estimate_psd(torch.from_numpy(x), nfft=nfft, fs=fs)
    jfreq, jpsd = jfourier.estimate_psd(jnp.asarray(x), nfft=nfft, fs=fs)
    np.testing.assert_array_equal(freq, jfreq)
    np.testing.assert_allclose(psd.numpy(), np.asarray(jpsd), atol=1e-3)
    assert abs(freq[int(np.argmax(psd.numpy()))] - 6000.0) < fs / nfft
