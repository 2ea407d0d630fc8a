"""echoseal_torch diagnostics vs echoseal_tpu's, on the CPU.

Each port diagnostic runs beside its JAX twin on the same inputs.  Both
packages draw every random byte (session nonces, payload pads, AEAD
nonces) through ``secrets.token_bytes``, which the ``pinned_secrets``
fixture replaces with zero bytes so that both TX paths build the same
frames.

* ``pn_check``, ``frozen_check``, ``polar_roundtrip`` print the same
  report.
* ``frame_check``: header reads and ``lo16`` equal; the chip BER within
  0.005 (ROADMAP C1: the compat exact inversion is not reproducible
  across float32 implementations).
* ``stage_compare``: the JSON reports' integers, bools and strings equal,
  floats within 1e-3, for v2 through MP3-sim and for compat.
* ``capability_report``: both packages' verifiers are replaced by one
  recording stub (and the compat bulk TX by one shared stand-in, since the
  two packages' device TX differ in float rounding); the reports' keys
  and the clips the stub sees, in order, are equal.
"""
import contextlib
import io
import json
import secrets

import numpy as np
import pytest

from echoseal_torch.convert import DETECTOR_TABLE_DTYPES, numpy_tables_of
from echoseal_torch.diagnostics import capability_report as Pcap
from echoseal_torch.diagnostics import frame_check as Pfc
from echoseal_torch.diagnostics import frozen_check as Pfz
from echoseal_torch.diagnostics import pn_check as Ppn
from echoseal_torch.diagnostics import polar_roundtrip as Ppr
from echoseal_torch.diagnostics import stage_compare as Psc
from echoseal_torch.models import detector as Pdet
from echoseal_torch.models import embedder as Pemb
from echoseal_torch.models import robust as Prob
from echoseal_tpu.diagnostics import capability_report as Jcap
from echoseal_tpu.diagnostics import frame_check as Jfc
from echoseal_tpu.diagnostics import frozen_check as Jfz
from echoseal_tpu.diagnostics import pn_check as Jpn
from echoseal_tpu.diagnostics import polar_roundtrip as Jpr
from echoseal_tpu.diagnostics import stage_compare as Jsc
from echoseal_tpu.models import detector as Jdet
from echoseal_tpu.models import embedder as Jemb
from echoseal_tpu.models import robust as Jrob
from torch_port_util import two_torch_threads  # noqa: F401

FLOAT_TOL = 1e-3


@pytest.fixture
def pinned_secrets(monkeypatch):
    monkeypatch.setattr(secrets, "token_bytes", lambda n=32: bytes(n))


def printed(fn, *args, **kwargs) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    return buf.getvalue()


def test_pn_check_prints_the_same_lines():
    out = printed(Ppn.main)
    assert out == printed(Jpn.main)
    assert "FAIL" not in out and "golden PN parity: OK" in out


def test_frozen_check_audit_passes_in_both():
    out = printed(Pfz.audit, device="cpu")
    assert out == printed(Jfz.audit)
    assert out.rstrip().endswith("AUDIT PASS")
    assert Pfz.audit(verbose=False, device="cpu") is True
    assert Jfz.audit(verbose=False) is True


def test_polar_roundtrip_prints_the_same_report():
    out = printed(Ppr.main, trials=4, list_size=8, device="cpu")
    assert out == printed(Jpr.main, trials=4, list_size=8)
    assert len(out.splitlines()) == 1 + 2 * 4


def _frame_rows(out: str):
    rows = [ln.split() for ln in out.splitlines()[1:]]
    return [(int(r[0]), " ".join(r[1:3]), float(r[3]), float(r[4]), r[5],
             int(r[6])) for r in rows]


def test_frame_check_matches(pinned_secrets, monkeypatch, key32):
    """The port's detector is built on the JAX detector's tables
    (``tests/test_torch_detector.py`` holds them equal to its own), so the
    float64 designs run once."""
    j_rows = _frame_rows(printed(Jfc.main))
    tables = numpy_tables_of(Jdet.WatermarkDetector(key32, list_size=8),
                             DETECTOR_TABLE_DTYPES)
    monkeypatch.setattr(Pdet, "host_tables", lambda sec, fs: tables)
    p_rows = _frame_rows(printed(Pfc.main, device="cpu"))
    assert len(p_rows) == len(j_rows) == 4
    for p, j in zip(p_rows, j_rows):
        assert (p[0], p[1], p[4], p[5]) == (j[0], j[1], j[4], j[5])
        assert p[4] == "True" and p[5] == p[0]
        assert abs(p[2] - j[2]) <= 0.005
        assert p[3] == pytest.approx(j[3], abs=FLOAT_TOL)


def _assert_report_close(p, j, path="report"):
    if isinstance(j, dict):
        assert isinstance(p, dict) and p.keys() == j.keys(), path
        for k in j:
            _assert_report_close(p[k], j[k], f"{path}.{k}")
    elif isinstance(j, float) and not isinstance(j, bool):
        assert isinstance(p, float) and abs(p - j) <= FLOAT_TOL, (path, p, j)
    else:
        assert type(p) is type(j) and p == j, (path, p, j)


@pytest.mark.parametrize("argv", [["--profile", "v2", "--impair", "mp3"],
                                  ["--profile", "compat"]])
def test_stage_compare_report_matches(pinned_secrets, monkeypatch, argv):
    """The port reads the JAX package's cached v2 demod designs, which
    ``tests/test_torch_robust.py`` holds bit-equal to its own, so the
    float64 designs (about 3 s each) run once."""
    monkeypatch.setattr(Prob, "robust_demod_matrix",
                        Jrob.robust_demod_matrix)
    j = json.loads(printed(Jsc.main, argv))
    p = json.loads(printed(Psc.main, argv + ["--device", "cpu"]))
    _assert_report_close(p, j)
    # frame 1 hops to the 16-18 kHz band, which the MP3-sim lowpass removes
    assert p["crypto"]["ctr_ok"] is (argv[1] == "compat")


def test_capability_report_same_grid_and_clips(pinned_secrets, monkeypatch):
    """The verifiers' constructors are stubbed too: building them designs
    the v2 demod tables (about 9 s per package), which no verdict here
    reads."""
    seen = {"port": [], "jax": []}
    built = {"port": [], "jax": []}

    def recorder(side):
        def init(self, key32, **kwargs):
            built[side].append((type(self).__name__, key32, kwargs))
            self.session_nonce = None

        def verify(self, audio, fs_in):
            seen[side].append((type(self).__name__, fs_in,
                               np.array(audio, copy=True)))
            return len(seen[side]) % 3 == 0
        return init, verify

    def embed(self, host, start_ctr=0, session_nonce=None, **_):
        # one stand-in for both packages' bulk TX
        assert session_nonce == b"capcheck"
        t = np.arange(host.size) / 48_000
        return (host + 0.01 * np.sin(2 * np.pi * 19_000 * t)).astype(
            np.float32)

    for side, det, rob, emb in (("port", Pdet, Prob, Pemb),
                                ("jax", Jdet, Jrob, Jemb)):
        init, verify = recorder(side)
        for cls in (det.WatermarkDetector, rob.RobustVerifier):
            monkeypatch.setattr(cls, "__init__", init)
            monkeypatch.setattr(cls, "verify", verify)
        monkeypatch.setattr(emb.BatchEmbedder, "embed", embed)
    p = json.loads(printed(Pcap.main, seconds=3.0, device="cpu"))
    j = json.loads(printed(Jcap.main, seconds=3.0))
    assert p == j
    assert list(p) == ["silence", "tone1k@-20dB", "noise@-40dB"]
    assert all(len(row) == 7 for row in p.values())
    assert [b[:2] for b in built["port"]] == [b[:2] for b in built["jax"]]
    assert [b[2] for b in built["port"]] == [
        dict(b[2], device="cpu") for b in built["jax"]]
    assert len(seen["port"]) == len(seen["jax"]) == 3 * 7 * 2
    for (pn, pf, pa), (jn, jf, ja) in zip(seen["port"], seen["jax"]):
        assert (pn, pf) == (jn, jf)
        assert pa.dtype == ja.dtype and np.array_equal(pa, ja)
