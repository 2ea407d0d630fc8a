"""echoseal_torch v2 batch verify on impaired captures vs echoseal_tpu's.

Tone-host clips (the ``benchmarks/impaired_bench.py`` v2 host: 0.15 x
700 Hz) embedded through the port's seeded ``RobustEmbedder(rng=)``, cut
at seeded starts, then 4 through MP3-sim (``codec_sim`` at 128 kbps) and
4 through ``reverb(6 dB, 150 ms)`` with a seeded room.  No ``secrets``
randomness reaches them.  The same clips go through the JAX
``RobustBatchVerifier`` and the port's on identical tables (read off the
JAX verifier); under ROADMAP C3 the verdicts and the accepting stage are
held row-identical.
"""
import numpy as np
import pytest

from echoseal_torch.convert import V2_TABLE_DTYPES, numpy_tables_of
from echoseal_torch.models import pipeline as PP
from echoseal_torch.models.robust import RobustEmbedder
from echoseal_torch.utils import channels
from echoseal_tpu.models import pipeline as JPL
from torch_port_util import two_torch_threads  # noqa: F401

FS = 48_000
T = int(3.5 * FS)
TPAD = 184_320               # the impaired bench's row width
MAX_CTR = 4096
N_EACH = 4


@pytest.fixture(scope="module")
def impaired(key32):
    """(clips (8, TPAD), n_valid, names): 4 MP3-sim, then 4 reverb."""
    rng = np.random.default_rng(21)
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(8 * FS) / FS)
            ).astype(np.float32)
    stream = RobustEmbedder(key32, rng=rng).process(host)
    starts = rng.integers(0, stream.size - T, 2 * N_EACH)
    clips = np.zeros((2 * N_EACH, TPAD), np.float32)
    for i, s in enumerate(starts):
        x = stream[s:s + T].copy()
        clips[i, :T] = (channels.codec_sim(x, 128.0)[:T] if i < N_EACH
                        else channels.reverb(x, 150.0,
                                             direct_to_reverb_db=6.0,
                                             rng=rng))
    names = ["mp3-128k(sim)"] * N_EACH + ["reverb(6dB,150ms)"] * N_EACH
    return clips, np.full(2 * N_EACH, T, np.int32), names


@pytest.fixture(scope="module")
def both(key32):
    """The JAX verifier and the port's on identical tables."""
    jv = JPL.RobustBatchVerifier(key32, max_ctr=MAX_CTR)
    pv = PP.RobustBatchVerifier.from_tables(
        key32, numpy_tables_of(jv, V2_TABLE_DTYPES), device="cpu")
    return jv, pv


def test_impaired_verdicts_and_stages_match_jax(both, impaired):
    jv, pv = both
    clips, nv, names = impaired
    d_p, d_j = {}, {}
    v_p = pv.verify_batch(clips, nv, details=d_p)
    v_j = jv.verify_batch(clips, nv, details=d_j)
    assert v_p.tolist() == np.asarray(v_j).tolist()
    assert {i: d.stage for i, d in d_p.items()} == \
        {i: d.stage for i, d in d_j.items()}
    assert {i: d.frame_ctr for i, d in d_p.items()} == \
        {i: d.frame_ctr for i, d in d_j.items()}
    # both classes sit inside the v2 envelope on a tone host
    # (benchmarks/impaired_1k.json: MP3-sim 0.999, reverb 1.0)
    assert v_p.all(), dict(zip(names, v_p.tolist()))
