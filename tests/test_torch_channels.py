"""echoseal_torch channel impairments vs echoseal_tpu's, on the CPU.

Every function of ``utils/channels.py`` is a host numpy transform in both
packages, so the port's output must be bit-identical (``np.array_equal``,
same dtype) to the JAX function's on the same 0.5 s seeded clip and the
same seeded ``rng``.
"""
import numpy as np
import pytest

from echoseal_torch.utils import channels as P
from echoseal_tpu.utils import channels as J
from torch_port_util import two_torch_threads  # noqa: F401

FS = 48_000
SEED = 5


@pytest.fixture(scope="module")
def clip():
    """0.5 s: a 700 Hz tone under white noise, seeded."""
    rng = np.random.default_rng(SEED)
    t = np.arange(FS // 2) / FS
    return (0.1 * np.sin(2 * np.pi * 700 * t)
            + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def rng_(seed=11):
    return np.random.default_rng(seed)


# (name, call) -- each call takes the module and the clip
CASES = {
    "awgn": lambda C, x: C.awgn(x, 6.0, rng_()),
    "awgn_default_rng": lambda C, x: C.awgn(x, -15.0),
    "lowpass": lambda C, x: C.lowpass(x, 3500.0),
    "clip": lambda C, x: C.clip(x, 0.05),
    "time_scale": lambda C, x: C.time_scale(x, 1.031),
    "time_scale_slow": lambda C, x: C.time_scale(x, 0.953),
    "codec_sim": lambda C, x: C.codec_sim(x, 128.0),
    "codec_sim_64k": lambda C, x: C.codec_sim(x, 64.0),
    "codec_ulaw": lambda C, x: C.codec_ulaw(x),
    "codec_alaw": lambda C, x: C.codec_alaw(x),
    "codec_adpcm": lambda C, x: C.codec_adpcm(x),
    "codec_mpeg1_l2": lambda C, x: C.codec_mpeg1_l2(x, 128),
    "codec_mpeg1_l3": lambda C, x: C.codec_mpeg1_l3(x, 64),
    "codec_ratecv": lambda C, x: C.codec_ratecv(x, FS, 44_100),
    "excerpt": lambda C, x: C.excerpt(x, 0.2, rng=rng_()),
    "excerpt_whole": lambda C, x: C.excerpt(x, 1.0, rng=rng_()),
    "dropout": lambda C, x: C.dropout(x, 5.0, 6.0, rng=rng_()),
    "reverb": lambda C, x: C.reverb(x, 150.0, direct_to_reverb_db=6.0,
                                    rng=rng_()),
    "reverb_far": lambda C, x: C.reverb(x, 300.0, direct_to_reverb_db=0.0,
                                        rng=rng_(12)),
    "resonator": lambda C, x: C._resonator(x.astype(np.float64), 730.0,
                                           90.0, FS),
    "pcm16": lambda C, x: C._from_pcm16(C._to_pcm16(1.5 * x)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_channel_bit_identical_to_jax(clip, name):
    got = CASES[name](P, clip.copy())
    want = CASES[name](J, clip.copy())
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dr_db", [6.0, 30.0])
def test_room_impulse_response_bit_identical(dr_db):
    """Both budget branches: at 30 dB (budget 1e-3) the first bounce
    alone (amplitude >= 0.32) exceeds 0.75 of the reverberant budget, so
    the reflections are scaled down to fit; at 6 dB the first bounce keeps
    its drawn amplitude (0.32-0.5)."""
    got = P.room_impulse_response(150.0, direct_to_reverb_db=dr_db, rng=rng_())
    want = J.room_impulse_response(150.0, direct_to_reverb_db=dr_db,
                                   rng=rng_())
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert got[0] == 1.0
    peak_rest = float(np.abs(got[1:]).max())
    assert peak_rest < 0.05 if dr_db == 30.0 else peak_rest > 0.3


def test_speech_host_bit_identical():
    got = P.speech_host(2.0, rng=np.random.default_rng(77))
    want = J.speech_host(2.0, rng=np.random.default_rng(77))
    assert got.shape == (2 * FS,) and got.dtype == np.float32
    assert np.array_equal(got, want)
    assert float(np.abs(got).max()) <= 0.7 + 1e-6
    assert P._VOWELS == J._VOWELS


def test_audioop_is_the_stdlib_module():
    assert P._audioop() is J._audioop()
