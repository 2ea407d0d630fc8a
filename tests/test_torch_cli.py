"""echoseal_torch WAV I/O, audio loops and CLIs vs echoseal_tpu's, on the CPU.

The cases of tests/test_cli_io.py, each on the same seeded file through
both packages: the port's WAV reader returns what the JAX package's
returns, sample for sample, and its writer the same bytes; both RX CLIs
print the same verdict lines and exit codes (the port's run with
``--device cpu``); the TX CLI's offline output verifies in both.
"""
import numpy as np
import pytest
import torch

from echoseal_torch.cli import rx_app, tx_app
from echoseal_torch.io import wavio
from echoseal_torch.io.audioloop import AudioLoop, NullAudioLoop
from echoseal_torch.models.embedder import WatermarkEmbedder
from echoseal_tpu.cli import rx_app as j_rx_app
from echoseal_tpu.io import wavio as j_wavio
from torch_port_util import (  # noqa: F401
    compat_stream,
    two_torch_threads,
    v2_stream,
)

FS = 48_000
KEY_A = bytes.fromhex("aa" * 32)
HEX_A, HEX_B = "aa" * 32, "bb" * 32


# ------------------------------------------------------------------ WAV I/O
@pytest.mark.parametrize("subtype,atol", [("float32", 1e-7), ("pcm16", 1e-4)])
def test_wav_roundtrip_and_reader_parity(tmp_path, rng, subtype, atol):
    x = (0.1 * rng.standard_normal(FS // 2)).astype(np.float32)
    p = str(tmp_path / "t.wav")
    wavio.write(p, x, FS, subtype=subtype)
    y, fs = wavio.read(p)
    assert fs == FS and y.dtype == np.float32
    np.testing.assert_allclose(y, x, atol=atol)
    jy, jfs = j_wavio.read(p)                       # the JAX reader
    assert jfs == fs
    np.testing.assert_array_equal(y, jy)
    jp = str(tmp_path / "j.wav")
    j_wavio.write(jp, x, FS, subtype=subtype)       # the JAX writer
    assert open(jp, "rb").read() == open(p, "rb").read()


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_wav_stereo_downmix_matches_jax_reader(tmp_path, rng, width):
    import wave

    n = 1000
    hi = 1 << (8 * width - 1)
    pcm = rng.integers(-hi, hi, (n, 2))
    if width == 1:
        raw = (pcm + 128).astype(np.uint8).tobytes()
    else:
        raw = b"".join(int(v).to_bytes(width, "little", signed=True)
                       for v in pcm.ravel())
    p = str(tmp_path / "s.wav")
    with wave.open(p, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(width)
        w.setframerate(44_100)
        w.writeframes(raw)
    y, fs = wavio.read(p)
    jy, _ = j_wavio.read(p)
    assert fs == 44_100 and y.shape == (n,)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(y, pcm.mean(axis=1) / hi, atol=1e-6)
    with pytest.raises(ValueError):
        wavio.read(__file__)


def test_null_audio_loop_and_gated_live_loop(tmp_path, key32):
    tx = WatermarkEmbedder(key32, rng=np.random.default_rng(9))
    save = str(tmp_path / "save.wav")
    host = np.zeros(3000, np.float32)
    out = NullAudioLoop(tx.process, fs=FS, save_path=save).run(host)
    assert out.shape == host.shape and tx.frame_ctr == 3
    np.testing.assert_array_equal(wavio.read(save)[0], out)
    assert NullAudioLoop(tx.process).run(np.zeros(0, np.float32)).size == 0
    loop = AudioLoop(tx.process, fs=FS)
    try:
        import sounddevice  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="sounddevice"):
            loop.start()
    loop.stop()                       # a no-op before start


# --------------------------------------------------------------------- CLIs
@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    files = {}
    for name, x in (
            ("compat", compat_stream(KEY_A, 6, seed=11)),
            ("v2", v2_stream(KEY_A, 6, seed=12, nonce=b"cliv2ses")),
            ("noise", (0.05 * np.random.default_rng(13).standard_normal(
                4 * FS)).astype(np.float32))):
        files[name] = str(d / f"{name}.wav")
        wavio.write(files[name], x, FS)
    return files


def both_cli(capsys, argv, loose_ctr=False):
    """Run both RX CLIs; assert equal exit codes and verdict lines.

    ``loose_ctr`` drops the `` ctr=N`` of the compat monitor's lines from
    the comparison: the two packages may name different frames of one
    window (ROADMAP C1).
    """
    import re

    rc_p = rx_app.main(argv + ["--device", "cpu"])
    out_p = capsys.readouterr().out
    rc_j = j_rx_app.main(argv)
    out_j = capsys.readouterr().out
    if loose_ctr:
        assert re.sub(r" ctr=\d+", "", out_p) == re.sub(r" ctr=\d+", "", out_j)
        assert rc_p == rc_j
    else:
        assert (rc_p, out_p) == (rc_j, out_j)
    return rc_p, out_p


def test_cli_offline_tx_then_rx(tmp_path, capsys, key32):
    infile, outfile = str(tmp_path / "host.wav"), str(tmp_path / "wm.wav")
    wavio.write(infile, np.zeros(int(3.5 * FS), np.float32), FS)
    assert tx_app.main(["--key", HEX_A, "--infile", infile,
                        "--outfile", outfile]) == 0
    assert "watermarked 3.5s" in capsys.readouterr().err
    rc, out = both_cli(capsys, ["--key", HEX_A, "--audio", outfile,
                                "--list-size", "8"])
    assert rc == 0 and out == "authentic\n"
    rc, out = both_cli(capsys, ["--key", HEX_B, "--audio", outfile,
                                "--list-size", "8"])
    assert rc == 1 and out == "tampered / no watermark\n"
    wavio.write(infile, np.zeros(1000, np.float32), 44_100)
    with pytest.raises(SystemExit, match="48000 Hz"):
        tx_app.main(["--key", HEX_A, "--infile", infile])


def test_cli_v2_profile_roundtrip(tmp_path, capsys):
    host, wm = str(tmp_path / "host.wav"), str(tmp_path / "wm.wav")
    wavio.write(host, np.zeros(4 * FS, np.float32), FS)
    assert tx_app.main(["--key", HEX_A, "--profile", "v2", "--infile", host,
                        "--outfile", wm]) == 0
    capsys.readouterr()
    rc, out = both_cli(capsys, ["--key", HEX_A, "--profile", "v2",
                                "--audio", wm])
    assert rc == 0 and out == "authentic\n"
    # compat RX must NOT accept a v2 stream (wire-incompatible by design)
    rc, _ = both_cli(capsys, ["--key", HEX_A, "--audio", wm,
                              "--list-size", "8"])
    assert rc == 1


def test_cli_many_files_and_batch(wavs, capsys):
    argv = ["--key", HEX_A, "--list-size", "8", "--audio", wavs["compat"],
            wavs["noise"]]
    rc, out = both_cli(capsys, argv)
    assert rc == 1 and out.splitlines() == [
        f"{wavs['compat']}: authentic",
        f"{wavs['noise']}: tampered / no watermark"]
    rc_b, out_b = both_cli(capsys, argv + ["--batch"])
    assert (rc_b, out_b) == (rc, out)


def test_cli_monitor(wavs, capsys):
    rc, out = both_cli(capsys, ["--key", HEX_A, "--monitor", "--list-size",
                                "8", "--audio", wavs["compat"]],
                       loose_ctr=True)
    lines = out.splitlines()
    assert rc == 0 and len(lines) == 2
    assert all("authentic ctr=" in ln and "stage=hard" in ln for ln in lines)
    assert lines[0].startswith(f"{wavs['compat']} [   0.00s -    4.00s]")
    rc, out = both_cli(capsys, ["--key", HEX_B, "--monitor", "--list-size",
                                "8", "--audio", wavs["noise"]])
    assert rc == 1 and out.splitlines() == [
        f"{wavs['noise']} [   0.00s -    4.00s] ---"]


def test_cli_monitor_batch_v2(wavs, capsys):
    rc, out = both_cli(capsys, ["--key", HEX_A, "--monitor", "--batch",
                                "--profile", "v2", "--audio", wavs["v2"]])
    lines = out.splitlines()
    assert rc == 0 and len(lines) == 2
    assert all(" authentic ctr=" in ln and " stage=" in ln for ln in lines)


def test_cli_argument_checks(tmp_path, key32, monkeypatch):
    assert tx_app.load_key(HEX_A) == key32
    kf = tmp_path / "key.bin"
    kf.write_bytes(key32)
    assert rx_app.load_key(str(kf)) == key32
    with pytest.raises(SystemExit):
        tx_app.load_key(str(tmp_path / "missing.bin"))
    with pytest.raises(SystemExit):
        tx_app.main(["--key", "aa" * 24])   # valid hex, wrong length
    with pytest.raises(SystemExit):
        rx_app.main(["--key", HEX_A])       # no --audio
    with pytest.raises(SystemExit):        # compat TX is fixed-rate
        tx_app.main(["--key", HEX_A, "--payload-k", "360",
                     "--infile", "x.wav", "--outfile", "y.wav"])
    with pytest.raises(SystemExit):        # compat RX is fixed-rate
        rx_app.main(["--key", HEX_A, "--payload-k", "360", "--audio", "x.wav"])
    with pytest.raises(SystemExit):        # monitor runs at default rate
        rx_app.main(["--key", HEX_A, "--profile", "v2", "--monitor",
                     "--payload-k", "360", "--audio", "x.wav"])
    with pytest.raises(SystemExit):        # not a rate the profile offers
        rx_app.main(["--key", HEX_A, "--profile", "v2", "--payload-k", "361",
                     "--audio", "x.wav"])
    # --native selects the C ring mixer (tests/test_torch_native_gui.py)
    assert tx_app.parse_args(["--key", HEX_A, "--native"]).native is True
    assert tx_app.parse_args(["--key", HEX_A]).native is False
    assert rx_app.parse_args(["--key", HEX_A]).device == "cuda"

    seen = {}

    class _SpyVerifier:
        def __init__(self, key, *, list_size, profile, device):
            seen.update(k=profile.payload_k, name=profile.name, device=device)

        def verify(self, data, fs):
            return False

    import echoseal_torch.models.robust as robust_mod

    monkeypatch.setattr(robust_mod, "RobustVerifier", _SpyVerifier)
    wav = str(tmp_path / "a.wav")
    wavio.write(wav, np.zeros(FS, np.float32), FS)
    argv = ["--key", HEX_A, "--profile", "v2", "--payload-k", "360",
            "--audio", wav]
    assert rx_app.main(argv) == 1
    assert seen == {"k": 360, "name": "robust-k360", "device": None}
    assert rx_app.main(argv + ["--device", "cpu"]) == 1
    assert seen["device"] == "cpu"


def test_cli_default_device_needs_a_card(wavs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--batch", "--monitor"], ["--profile", "v2"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rx_app.main(["--key", HEX_A, "--audio", wavs["noise"]] + extra)
