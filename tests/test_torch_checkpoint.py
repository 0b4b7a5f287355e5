"""The port's checkpoint format against sdr_tpu's: the same key paths for
every profile the CLI builds and for the wideband (channelizer, receiver)
pair, a bit-exact resume within the port, and the reference's error
cases."""

import collections

import numpy as np
import pytest
import torch

from sdr_tpu.models.receiver import Receiver as JaxReceiver
from sdr_tpu.models.wideband import WidebandReceiver as JaxWideband
from sdr_tpu.ops.channelizer import WidebandChannelizer as JaxChannelizer
from sdr_tpu.utils import checkpoint as jckpt
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.models.wideband import WidebandReceiver
from sdr_tpu_torch.ops.channelizer import WidebandChannelizer
from sdr_tpu_torch.utils.checkpoint import (_flatten, leaf_paths, load_state,
                                            save_state)

from test_torch_stereo_receiver import capture

# the Receiver kwargs each CLI profile builds (sdr_tpu/cli.py:134-141 and
# :404-405 for --stations)
FAST = dict(fused_frontend="int8", pll_impl="ff", conv_dtype="bf16",
            conv_engine="tiled")
STATIONS_FAST = dict(fused_frontend="bf16", pll_impl="ff", conv_dtype="bf16")
CLI_PROFILES = {
    "mono": {},
    "mono_fast": FAST,
    "mono_exact_fast": dict(fused_frontend="int8x2"),
    "mono_psd": dict(emit_if=True),
    "stereo": dict(stereo=True),
    "stereo_fast": dict(FAST, stereo=True),
    "rds_fast": dict(FAST, rds=True),
    "stereo_rds": dict(stereo=True, rds=True),
    "stereo_rds_fast": dict(FAST, stereo=True, rds=True,
                            fused_ifbank="bf16"),
    "stereo_rds_fast_exact": dict(FAST, stereo=True, rds=True,
                                  fused_ifbank="bf16",
                                  fused_frontend="int8x2"),
    "stereo_rds_exact_fast": dict(stereo=True, rds=True,
                                  fused_frontend="int8x2"),
    "stations_fast_stereo_rds": dict(STATIONS_FAST, stereo=True, rds=True),
    "stations_fast_mono": STATIONS_FAST,
}


@pytest.mark.parametrize("profile", sorted(CLI_PROFILES))
@pytest.mark.parametrize("batch", [(), (3,)], ids=["one", "stations"])
def test_key_paths_match_reference(profile, batch):
    kw = CLI_PROFILES[profile]
    want = jckpt._leaf_paths(JaxReceiver(0, **kw).init_state(batch))
    got = leaf_paths(Receiver(0, **kw, device="cpu").init_state(batch))
    assert got == want
    assert got[0] == ".front.i_tail"
    if kw.get("rds") and kw.get("stereo"):
        assert len(got) == 27 and got[-1] == ".rds.rrc_tail"
    elif not (kw.get("stereo") or kw.get("rds")):
        assert len(got) == 6 and got[-1] == ".mono.deemph"


@pytest.mark.parametrize("kw", [
    dict(engine="mfb", ingest="f32", compute_dtype="f32"),
    dict(engine="pallas", ingest="u8", compute_dtype="bf16"),
    dict(engine="mix")], ids=["mfb", "pallas_u8", "mix"])
def test_wideband_pair_key_paths_match_reference(kw):
    freqs = [-1.0e6, 0.0, 1.5e6]
    rx = dict(stereo=True, rds=True, fused_frontend=False, pll_impl="ff")
    want = jckpt._leaf_paths(JaxWideband(
        JaxChannelizer(9.6e6, 2.4e6, freqs, **kw),
        JaxReceiver(0, **rx)).init_state())
    got = leaf_paths(WidebandReceiver(
        WidebandChannelizer(9.6e6, 2.4e6, freqs, **kw, device="cpu"),
        Receiver(0, **rx, device="cpu")).init_state())
    assert got == want
    assert got[0].startswith("[0]['") and got[-1] == "[1].rds.rrc_tail"


def test_manifest_dtypes_match_reference(tmp_path):
    """The --fast stereo + RDS state has float32, bfloat16 and uint8
    leaves; both packages write the same manifest and the same bits."""
    kw = CLI_PROFILES["stereo_rds_fast"]
    jst = JaxReceiver(0, **kw).init_state()
    st = Receiver(0, **kw, device="cpu").init_state()
    a, b = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_state(a, jst)
    save_state(b, st)
    with np.load(a) as ja, np.load(b) as tb:
        assert sorted(ja.files) == sorted(tb.files)
        assert set(str(d) for d in tb["__dtypes__"]) == {"float32",
                                                         "bfloat16", "uint8"}
        for k in ja.files:
            assert ja[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(ja[k], tb[k])


@pytest.mark.parametrize("profile,batch", [
    ("mono", (2,)), ("stereo_rds_fast", ()), ("stations_fast_stereo_rds",
                                              (2,))])
def test_port_resume_is_exact(tmp_path, profile, batch):
    """A run cut in two by save and load equals the uninterrupted run bit
    for bit (outputs and final state)."""
    kw = CLI_PROFILES[profile]
    rx = Receiver(0, **kw, device="cpu")
    cap = capture(0, 0.3)
    if batch:
        cap = np.stack([cap, np.roll(cap, 4096)])
    bs = rx.block_size_u8(2)
    half = cap.shape[-1] // 2 // bs * bs
    first, second = cap[..., :half], cap[..., half:]
    full, fst = rx.run(cap, blocks_per_step=2)
    out1, st = rx.run(first, blocks_per_step=2)
    path = str(tmp_path / "state.npz")
    save_state(path, st)
    out2, st2 = rx.run(second, blocks_per_step=2,
                       state=load_state(path, rx.init_state(batch)))
    for k in full:
        assert torch.equal(torch.cat([out1[k], out2[k]], dim=-1), full[k]), k
    assert leaf_paths(st2) == leaf_paths(fst)
    for (p, a), (_, b) in zip(_flatten(st2), _flatten(fst)):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_wideband_pair_resume_is_exact(tmp_path):
    """The (channelizer dict, ReceiverState) pair saves and loads: the
    continued stream equals the uninterrupted one bit for bit."""
    from sdr_tpu_torch.ops.channelizer import synthesize_wideband
    from sdr_tpu_torch import tx
    fs = 2.4e6
    n = int(0.1 * fs)
    st = [tx.fm_modulate(tx.make_multiplex(fs, n, mono=tx.tone(fs, f, n)),
                         fs) for f in (700.0, 1100.0)]
    iw, qw = synthesize_wideband([(i + 1j * q) * 0.3 for i, q in st],
                                 [-1.0e6, 1.2e6], fs, 9.6e6)
    wide = np.empty(2 * len(iw), np.float32)
    wide[0::2], wide[1::2] = iw, qw
    wrx = WidebandReceiver(
        WidebandChannelizer(9.6e6, fs, [-1.0e6, 1.2e6], engine="mfb",
                            device="cpu"),
        Receiver(0, device="cpu"))
    blk = wrx.block_wide()
    nb = len(wide) // blk
    full, _ = wrx.run(wide[:nb * blk])
    out1, state = wrx.run(wide[:(nb // 2) * blk])
    path = str(tmp_path / "wide.npz")
    save_state(path, state)
    out2, _ = wrx.run(wide[(nb // 2) * blk:nb * blk],
                      state=load_state(path, wrx.init_state()))
    assert torch.equal(torch.cat([out1["mono"], out2["mono"]], dim=-1),
                       full["mono"])


# the reference's error cases (tests/test_aux.py), on the port's tensors
def test_checkpoint_roundtrip(tmp_path):
    rx = Receiver(0, stereo=True, pll_impl="ff", device="cpu")
    cap = capture(0, 0.1, rds=False)
    half = len(cap) // 2 // rx.block_size_u8() * rx.block_size_u8()
    out1, st = rx.run(cap[:half])
    path = str(tmp_path / "state.npz")
    save_state(path, st)
    out2, _ = rx.run(cap[half: 2 * half],
                     state=load_state(path, rx.init_state()))
    full, _ = rx.run(cap[: 2 * half])
    joined = torch.cat([out1["mono"], out2["mono"]])
    np.testing.assert_allclose(joined.numpy(), full["mono"].numpy(),
                               atol=1e-6)


def test_checkpoint_shape_mismatch(tmp_path):
    rx = Receiver(0, device="cpu")
    path = str(tmp_path / "state.npz")
    save_state(path, rx.init_state())
    with pytest.raises(ValueError, match="saved shape"):
        load_state(path, rx.init_state((4,)))


def test_checkpoint_structure_mismatch(tmp_path):
    """A structurally different tree with identical leaf shapes is refused,
    naming the extra and the missing leaves."""
    path = str(tmp_path / "state.npz")
    save_state(path, {"a": torch.zeros(3), "b": torch.ones(3)})
    with pytest.raises(ValueError, match="structure mismatch") as e:
        load_state(path, {"x": torch.zeros(3), "y": torch.ones(3)})
    assert "['a']" in str(e.value) and "['x']" in str(e.value)


def test_checkpoint_same_structure_different_container(tmp_path):
    """Validation is by key paths: dict and OrderedDict interchange, a
    tuple with the same leaves is refused."""
    path = str(tmp_path / "state.npz")
    save_state(path, {"a": torch.arange(3.0), "b": torch.ones(2)})
    od = collections.OrderedDict([("a", torch.zeros(3)),
                                  ("b", torch.zeros(2))])
    got = load_state(path, od)
    assert isinstance(got, collections.OrderedDict)
    assert torch.equal(got["a"], torch.arange(3.0))
    with pytest.raises(ValueError, match="structure mismatch"):
        load_state(path, (torch.zeros(3), torch.zeros(2)))


def test_checkpoint_extra_leaves_rejected(tmp_path):
    """A v1 file (no manifest) with more leaves than expected is refused;
    one with the right count loads by shape alone."""
    path = str(tmp_path / "state.npz")
    with open(path, "wb") as f:
        np.savez(f, **{f"leaf_{i}": np.zeros(3) for i in range(3)})
    with pytest.raises(ValueError, match="more than the expected"):
        load_state(path, {"a": torch.zeros(3), "b": torch.zeros(3)})
    v1 = str(tmp_path / "v1.npz")
    with open(v1, "wb") as f:
        np.savez(f, leaf_0=np.arange(3.0), leaf_1=np.ones(3))
    got = load_state(v1, {"a": torch.zeros(3), "b": torch.zeros(3)})
    assert torch.equal(got["a"], torch.arange(3.0, dtype=torch.float64))


def test_dict_keys_flatten_sorted():
    """jax flattens dict keys in sorted order, whatever the insertion
    order."""
    tree = {"tail": torch.zeros(2), "phase": torch.zeros(1)}
    assert leaf_paths(tree) == ["['phase']", "['tail']"]
    assert leaf_paths((tree, None, [torch.zeros(1)])) == [
        "[0]['phase']", "[0]['tail']", "[2][0]"]
