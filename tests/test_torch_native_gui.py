"""echoseal_torch native C mixer, ``tx_app --native`` and the Tk GUIs, CPU.

The cases of tests/test_native.py and tests/test_gui.py on the port, with
the JAX package beside it where the two can run on the same input:

* the port's ``NativeMixer`` (its own copy of ``mixer.c``, built into
  ``build/echoseal_torch/``) equals the JAX package's exactly on the same
  chips and blocks, and the Python mix law within the tolerance of
  tests/test_native.py (rtol 1e-5, atol 1e-7);
* a seeded ``NativeStreamEmbedder`` stream equals the seeded
  ``WatermarkEmbedder`` stream within that tolerance, verifies, and
  rejects under a wrong key;
* ``tx_app --native`` output verifies with ``rx_app --device cpu``; with
  ``--profile v2`` or without a C compiler it says so on stderr and mixes
  in Python;
* the GUIs with a stubbed tkinter (the tests need no display): key
  checks, the audio loop's start and stop with a bounded VU queue, the
  worker-thread verify (``RxGUI(device="cpu")``), the file picker, and
  ``RxGUI()`` with no device, which on a host without CUDA posts an
  error, never a verdict.
"""
import sys
import threading
import time
from unittest import mock

import numpy as np
import pytest

from echoseal_torch import native as pnative
from echoseal_torch.cli import rx_app, tx_app
from echoseal_torch.io import wavio
from echoseal_torch.models.detector import WatermarkDetector
from echoseal_torch.models.embedder import WatermarkEmbedder
from echoseal_torch.native.stream import NativeStreamEmbedder
from echoseal_torch.ops.build import BUILD_DIR
from echoseal_tpu import native as jnative
from torch_port_util import (  # noqa: F401
    fake_tkinter,
    run_gui_verify,
    two_torch_threads,
)

FS = 48_000
HEX_A = "aa" * 32
MIX_TOL = dict(rtol=1e-5, atol=1e-7)


def _chips(key, n_frames, seed):
    tx = WatermarkEmbedder(key, rng=np.random.default_rng(seed))
    return np.concatenate([tx._make_frame_chips() for _ in range(n_frames)])


# -------------------------------------------------------------- the mixer
def test_native_mixer_equals_jax_mixer(key32):
    """Same C source, same flags: bit-equal blocks; the port's library is
    its own build, not the JAX package's."""
    chips = _chips(key32, 4, seed=1)
    ours, theirs = pnative.NativeMixer(), jnative.NativeMixer()
    assert ours.push_chips(chips) == theirs.push_chips(chips) == chips.size
    host = (0.1 * np.random.default_rng(2).standard_normal(4 * 1024)
            ).astype(np.float32)
    host[1024:2048] *= 20.0                          # the headroom limiter
    for i in range(0, host.size, 1024):
        (a, ua), (b, ub) = (m.process(host[i:i + 1024])
                            for m in (ours, theirs))
        assert ua == ub == 1024
        np.testing.assert_array_equal(a, b)
    assert ours.available_chips == theirs.available_chips
    lib = pnative.library_path()
    assert lib.parent == BUILD_DIR and lib.exists()
    assert pnative.load()._name == str(lib)
    assert "echoseal_tpu" not in pnative.load()._name


def test_native_mixer_matches_python_mixer(key32):
    chips = _chips(key32, 4, seed=3)
    nm = pnative.NativeMixer()
    assert nm.push_chips(chips) == chips.size
    tx = WatermarkEmbedder(key32, rng=np.random.default_rng(4))
    tx._chip_buf = chips.copy()
    tx.frame_ctr = 10**6         # keeps process() from rendering frames
    host = (0.1 * np.random.default_rng(5).standard_normal(3 * 1024)
            ).astype(np.float32)
    for i in range(0, host.size, 1024):
        blk = host[i:i + 1024]
        out_c, used = nm.process(blk)
        assert used == blk.size
        np.testing.assert_allclose(out_c, tx.process(blk), **MIX_TOL)


def test_native_mixer_starvation_passthrough():
    nm = pnative.NativeMixer()
    blk = (0.1 * np.random.default_rng(6).standard_normal(256)
           ).astype(np.float32)
    out, used = nm.process(blk)              # empty ring: passthrough
    assert used == 0
    np.testing.assert_array_equal(out, blk)


def test_native_ring_wraparound():
    nm = pnative.NativeMixer(capacity_pow2=10)      # a 1024-chip ring
    chips = np.random.default_rng(7).standard_normal(4096).astype(np.float32)
    pushed = nm.push_chips(chips)
    assert pushed == 1024 and nm.space == 0          # bounded by capacity
    _, used = nm.process(np.zeros(600, np.float32))
    assert used == 600 and nm.available_chips == 424
    assert nm.push_chips(chips[pushed:pushed + 500]) == 500   # wrapped
    out, used = nm.process(np.zeros(924, np.float32))
    assert used == 924 and nm.available_chips == 0
    assert np.abs(out).max() > 0


# ------------------------------------------------------------- the stream
def test_native_stream_equals_seeded_python_stream(key32):
    """Feeder thread + C ring: the seeded Python mixer's stream, which
    verifies and rejects under a wrong key."""
    host = np.zeros(4 * FS, np.float32)     # compat is for clean captures
    blocks = range(0, host.size, 1024)
    with NativeStreamEmbedder(key32, rng=np.random.default_rng(9)) as tx:
        deadline = time.time() + 10.0
        while (tx._mixer.available_chips < NativeStreamEmbedder.LOW_WATER
               and time.time() < deadline):
            time.sleep(0.01)             # the feeder renders ahead
        stream = np.concatenate([tx.process(host[i:i + 1024])
                                 for i in blocks])
        assert tx.frame_ctr > 150
    ref_tx = WatermarkEmbedder(key32, rng=np.random.default_rng(9))
    ref = np.concatenate([ref_tx.process(host[i:i + 1024]) for i in blocks])
    assert tx.session_nonce == ref_tx._session_nonce
    np.testing.assert_allclose(stream, ref, **MIX_TOL)
    assert not tx._feeder.is_alive()

    det = WatermarkDetector(key32, list_size=32, device="cpu")
    assert det.verify(stream, FS) is True
    bad = WatermarkDetector(bytes.fromhex("99" * 32), list_size=32,
                            device="cpu")
    assert bad.verify(stream, FS) is False


# ---------------------------------------------------------------- the CLI
@pytest.fixture()
def host_wav(tmp_path):
    path = str(tmp_path / "host.wav")
    wavio.write(path, np.zeros(int(3.5 * FS), np.float32), FS)
    return path


def test_tx_app_native_offline_verifies(tmp_path, capsys, host_wav):
    out = str(tmp_path / "wm.wav")
    assert tx_app.main(["--key", HEX_A, "--infile", host_wav, "--outfile",
                        out, "--native"]) == 0
    err = capsys.readouterr().err
    assert "watermarked 3.5s" in err and "Python mixer" not in err
    assert rx_app.main(["--key", HEX_A, "--audio", out, "--list-size", "8",
                        "--device", "cpu"]) == 0
    assert capsys.readouterr().out == "authentic\n"
    # the feeder thread went with the CLI call
    assert not any(t.name == "echoseal-tx-feeder" and t.is_alive()
                   for t in threading.enumerate())


def test_tx_app_native_v2_uses_python_mixer(tmp_path, capsys, host_wav):
    out = str(tmp_path / "wm.wav")
    assert tx_app.main(["--key", HEX_A, "--profile", "v2", "--infile",
                        host_wav, "--outfile", out, "--native"]) == 0
    err = capsys.readouterr().err
    assert "--native applies to the compat mixer; using Python mixer" in err
    wm, fs = wavio.read(out)
    assert fs == FS and wm.size == int(3.5 * FS) and np.abs(wm).max() > 0


def test_tx_app_native_without_compiler(tmp_path, capsys, host_wav,
                                        monkeypatch):
    monkeypatch.setattr(pnative, "available", lambda: False)
    out = str(tmp_path / "wm.wav")
    assert tx_app.main(["--key", HEX_A, "--infile", host_wav, "--outfile",
                        out, "--native"]) == 0
    err = capsys.readouterr().err
    assert "--native: no C compiler available, using Python mixer" in err
    assert rx_app.main(["--key", HEX_A, "--audio", out, "--list-size", "8",
                        "--device", "cpu"]) == 0
    assert capsys.readouterr().out == "authentic\n"


# --------------------------------------------------------------- the GUIs
@pytest.fixture()
def fake_tk(monkeypatch):
    """Stub tkinter modules for the GUIs' deferred imports."""
    mods = fake_tkinter()
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return mods["tkinter"]


def test_tx_gui_constructs_and_validates_key(fake_tk):
    from echoseal_torch.gui.tx_gui import TxGUI

    root = mock.MagicMock(name="root")
    gui = TxGUI(root=root)
    assert root.after.called                 # the VU poll is scheduled
    gui.key_var.set("zz")
    gui.toggle()
    assert gui._loop is None
    assert "key error" in gui.status.config.call_args.kwargs["text"]
    gui.key_var.set("aa" * 8)                # short key: the 32-byte gate
    gui.toggle()
    assert gui._loop is None
    assert "key error" in gui.status.config.call_args.kwargs["text"]


def test_tx_gui_start_stop_with_null_audio(fake_tk, monkeypatch):
    """Start wires the embedder to the audio loop, stop tears it down; the
    VU queue is bounded, so the audio callback never blocks on the UI."""
    import echoseal_torch.io.audioloop as al
    from echoseal_torch.gui import tx_gui

    started = {}

    class _FakeLoop:
        def __init__(self, process, device=None, fs=48_000, block=1024,
                     **kw) -> None:
            started["process"] = process
            started["device"] = device

        def start(self) -> None:
            started["running"] = True

        def stop(self) -> None:
            started["running"] = False

    monkeypatch.setattr(al, "AudioLoop", _FakeLoop)
    gui = tx_gui.TxGUI(root=mock.MagicMock())
    gui.key_var.set(HEX_A)
    gui.dev_var.set("3")
    gui.toggle()
    assert started["running"] and started["device"] == 3
    out = started["process"](np.zeros(1024, np.float32))
    assert out.shape == (1024,) and out.dtype == np.float32
    assert float(np.max(np.abs(out))) > 0           # watermark present
    for _ in range(64):
        started["process"](np.zeros(1024, np.float32))
    assert gui._vu.qsize() <= 8
    gui.toggle()                                     # stop
    assert started["running"] is False and gui._loop is None
    gui._poll()
    assert gui._vu.qsize() == 0


@pytest.fixture(scope="module")
def wm_wav(tmp_path_factory, key32):
    path = str(tmp_path_factory.mktemp("gui") / "wm.wav")
    tx = WatermarkEmbedder(key32, rng=np.random.default_rng(10))
    wavio.write(path, tx.process(np.zeros(3 * FS, np.float32)), FS)
    return path


def test_rx_gui_verify_paths(fake_tk, wm_wav):
    """Key errors and a missing file stop on the UI thread; a real file
    verifies on a worker thread, which posts the verdict via root.after."""
    from echoseal_torch.gui.rx_gui import RxGUI

    root = mock.MagicMock(name="root")
    gui = RxGUI(root=root, device="cpu")
    gui.key_var.set("nothex")
    gui._verify()
    assert "key error" in gui.verdict.config.call_args.kwargs["text"]
    gui.key_var.set(HEX_A)
    gui.file_var.set("")
    gui._verify()
    assert "choose a file" in gui.verdict.config.call_args.kwargs["text"]
    gui.file_var.set(wm_wav)
    assert run_gui_verify(gui, root) == "AUTHENTIC"


def test_rx_gui_file_picker(fake_tk):
    from echoseal_torch.gui.rx_gui import RxGUI

    gui = RxGUI(root=mock.MagicMock(), device="cpu")
    gui.filedialog.askopenfilename.return_value = "/tmp/x.wav"
    gui._pick()
    assert gui.file_var.get() == "/tmp/x.wav"


@pytest.mark.parametrize("profile", ["compat", "v2"])
def test_rx_gui_default_device_needs_a_card(fake_tk, wm_wav, profile,
                                            monkeypatch):
    """``device=None`` means CUDA: on a host without a card the verdict
    label reports the error and never a verdict."""
    import torch

    from echoseal_torch.gui.rx_gui import RxGUI

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = mock.MagicMock(name="root")
    gui = RxGUI(root=root)
    gui.key_var.set(HEX_A)
    gui.file_var.set(wm_wav)
    gui.profile_var.set(profile)
    text = run_gui_verify(gui, root)
    assert text.startswith("error: no CUDA device"), text
    assert "AUTHENTIC" not in text
