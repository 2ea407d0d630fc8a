#!/usr/bin/env python3
"""Drive echoseal_torch's main paths on one NVIDIA GPU and check every result.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, nvcc and nvidia-smi, and no network.  Phases, each
printing one JSON line (any failed check exits nonzero before the last
line):

1. environment: the card (``nvidia-smi`` name and power limit, also
   printed raw on a line of its own), torch and CUDA versions;
2. kernel build: every ``echoseal_torch/csrc/*.cu`` with nvcc, in parallel;
3. kernels: each kernel's wrapper against its plain torch version on the
   card at the batch paths' shapes, at the single-clip paths' row counts
   (37 and 800) and at a ragged one, with the memory/compute bound.  Each
   timed launch has a ~200 µs ``torch.cuda._sleep`` queued before its
   start event, so the card is still busy while the host runs the
   wrapper's checks and its ``ctypes`` launch, and the CUDA events bracket
   the kernel alone; the wrapper's host launch path is a separate
   host-clock reading (``launch_host_us``).  (a) ``payload_llr``, the
   LLR-only port of the TPU kernel; (b) ``payload_decode``, its redesign
   that every main path runs (PN gather, LLR, hard polar decode, CRC-8),
   on inputs with CRC-passing rows: info bits and ``crc_ok`` exact, LLRs
   within rtol = atol = KERNEL_TOL, its time beside ``payload_llr``'s, a one-element
   op's (the launch floor) and, on the host clock, the chain of torch
   ops and ``payload_llr`` it replaces; (c) ``scl_decode``, the exact SCL
   list decoder, against the eager walk it replaces on the card
   (``scl._scl_decode_plain``) at phase 10's 128 rows at L = 256, 32 rows
   at L = 256 and L = 32 (the single-clip tiers) and the v2 ladder's rungs
   (1024 and 321 rows at L = 8, 107 at L = 32), noisy rows with a
   noiseless and a zero-LLR one: per row the same CRC-passing payloads and
   first passing path, sorted metrics within rtol = atol = 1e-4, lists
   path for path except beside a near-equal metric (ties, counted); the
   kernel's and the walk's times, the bound (bytes, fp32 and exp/log1p
   operations) and the dependency floor (forks x one measured fork
   round); (d) ``scl_serving``, the same kernel's fast-SSCL instantiation,
   against the eager serving walk it replaces on the card
   (``scl._walk_decode(serving=True)``) at the serving ladder's rungs (v2
   1024 and 321 rows at L = 8, 107 at L = 32), compat 128 rows at L = 256
   and 32 at L = 32, v2 321 rows at ``block_seg`` 8 and compat 128 at
   L = 32 with ``block_seg`` 64 (nodes of 128 leaves), on the same kind of
   rows and under the same contract; its time, the walk's and the exact
   kernel's at the same shape in turns, the bound (bytes and fp32
   operations; no exp or log1p) and the floor (forks x one fork round of
   the serving kernel); (e) ``sync_xcorr``, the v2 batch sync on the
   tensor cores, against ``demod.sync_xcorr_plain`` on batch 0 of both v2
   cells of the benchmark at two of its seeds (1024 rows of T + 16 384), a
   recovery round's rows and ragged shapes: corr within SYNC_TOL, -inf at
   exactly the masked lags, the NMS peaks at the same lags but for ties;
   its time beside the plain version's, cuDNN's ``conv1d`` pair
   (``library_ms``) and the bound (bf16 tensor-core operations against
   bytes); (f) ``scale_scan``, the recovery's time-scale scan, against
   ``robust.scale_scan_plain`` on the recovery's scan chunk (the first
   SCAN_CHUNK rows of batch 0 of the benchmark's ``v2.recover-timescale``
   at a seed), the single-clip stage's one padded row and ragged rows:
   scores within SCAN_TOL, -inf exactly where the plain version has it,
   the picked factor the same but for ties; its time beside the plain
   version's, the cuFFT full-length scan it replaced (``library_ms``) and
   the bound (fp32 FFT operations against the rows and energies read);
   (g) ``resample``, the recovery's polyphase resample, against the torch
   loop ``resample._resample_stage`` it replaced, at a recovery call's
   retried rows (RS_ROWS x RS_T at key RS_DEN): relative error within
   RESAMPLE_TOL; its time beside the loop's and the bound (the rows read
   and written once);
4. compat main path at full width: a 4096-frame stream from the port's
   host TX (every random byte drawn from ``SEED``), B = 1024 clips of 3 s
   at 48 kHz cut at frame-aligned random starts,
   ``BatchVerifier(max_ctr=16384, peaks=2).verify_batch``; every clip must
   verify and the kernel must have launched; 64 noise clips and the same
   clips under a wrong key must all reject; a clip cut at counter 70 000
   must verify only through the extended-counter pass;
5. compat timing: one warm-up and 3 timed ``run_device`` + ``finish_host``
   runs, real-time factor and per-stage CUDA-event times;
6. the same 4 compat clips through the port on the card and on the CPU;
7. v2 main path at full width (the JAX ``bench.py`` metric-2 set-up): a
   12 s 700 Hz host through the port's seeded ``RobustEmbedder``, B = 1024
   clips of 3 s at random starts padded to T + 16384,
   ``RobustBatchVerifier(KEY)`` with its defaults; accept must be 1.0 and
   the kernel must have launched; 64 noise clips (which must reach no SCL
   dispatch) and the clips under a wrong key must all reject;
8. v2 timing: stage CUDA-event times, the ladder's host time, RTF (best of
   3 ``verify_batch``-equivalent runs after a warm-up), peak memory;
9. the SCL ladder at full width: B = 1024 mid-stream cuts of a silence-host
   v2 stream with white noise 4 dB below the watermark RMS; hard-pass and
   ladder accept, clips rescued by ``"scl"``, the time of each rung; the
   first 16 clips' verdicts on the card and on the CPU must agree;
10. SCL-256 (``bench.py`` metric 3): 128 compat-coded payloads through
    sigma 0.3 AWGN, decodes/s at L = 256; the CRC-passing payload sets of
    8 rows on the card and on the CPU must agree;
11. the same 4 v2 clips through the port on the card and on the CPU;
12. TX device synthesis at full width: ``BatchEmbedder(KEY).frames_device``
    for the 4096 counters of phase 4 with the same seeded generator; every
    frame within 2e-5 of phase 4's host-made frames; frames/s and the
    real-time factor of chips after a warm-up; 64 clips cut from the
    device-made stream must all pass the compat verify of phase 4;
13. 44.1 kHz ingest at full width: B = 1024 cuts of 3.5 s from the phase-7
    stream, resampled by scipy 147/160 into rows of 169 344 samples,
    ``verify_batch(cap, nv44, fs_in=44100)``; accept must be 1.0 and the
    same rows read as 48 kHz must all reject; the ingested rows of 8 clips
    within 1e-5 relative of ``resample_poly`` in float64; CUDA-event time
    of the ingest stage and host time of the whole call;
14. time-scale recovery at full width: the same cuts, each played 3.1 %
    fast (``time_scale(clip, 1.031)``), in rows of 184 320;
    ``verify_batch`` must accept none and ``verify_batch_recover`` at least
    0.95; the scan's and every retry round's time, rows and lattice
    denominators, kernel launches, peak memory; then 64 clips at mixed
    seeded factors in {0.953, 0.978, 1.0, 1.031, 1.047}: at least 0.9
    recovered, and every 1.0 clip accepted without a retry;
15. 4 of the phase-14 clips through ``verify_batch_recover`` on the card
    and on the CPU: verdicts and the lattice keys tried per clip agree;
16. compat single clip: a 16 s silence-host stream from ``BatchEmbedder``;
    the first verify's seconds; 30 distinct 3.5 s cuts, a fresh
    ``WatermarkDetector(KEY)`` each (built outside the timer): all must
    verify, p50/p99 ms and where the time goes; a wrong key and white noise
    must reject, with the seconds the full ladder took (SCL at L = 256);
    ``verify_raw_frame`` on one synthesized frame, right key and wrong;
17. v2 single clip: a 20 s 700 Hz host through the seeded
    ``RobustEmbedder``; 30 cuts through one ``RobustVerifier(KEY)``: all
    must verify, p50/p99 ms; one cut resampled to 44.1 kHz must verify; one
    cut played 3.1 % fast must verify with ``timescale`` within 1e-3 of
    0.97; noise must reject, with its seconds split into scan-bank design
    (designed anew), scan and SCL;
18. monitors and pool: ``StreamMonitor`` compat and v2 over a 20 s stream in
    1 s feeds, every window authentic, then a 6 s tail from another
    session whose windows must reject; ``BatchStreamMonitor(KEY)`` over
    120 s in 1 s feeds: accept 1.0, audio seconds per second, feed p50/p99
    ms; ``VerifierPool(profile="v2", max_keys=2)`` with 3 keys x 256 clips:
    per-key isolation, eviction, verdicts right after a re-build;
19. 4 clips per single-clip tier through the port on the card and on the
    CPU (the same tables): verdict, stage, session and ``timescale`` must
    be equal; so must the accepted frame (counter, band, peak position),
    except that a compat clip may accept another of its frames, since a
    marginal frame's hard decode can tip between two float32
    implementations of the lam=1e-12 inversion: then each side's counter
    must be the one its peak position implies.  The line counts the clips
    whose fields are all equal;
20. impaired captures, compat and v2 tone host (the set-up of
    ``benchmarks/impaired_bench.py``), B = 1024 clips of 3.5 s in rows of
    184 320 unless named: compat clean (accept 1.0), MP3-sim, AWGN +6 and
    -15 dB, +3.1 % speed and reverb (6 dB, 150 ms) on 128 clips (each
    0.0); v2 on the phase-7 stream: MP3-sim, AWGN +6 and -15 dB (0.0, they
    are clip-relative), AWGN at +6 dB re the watermark and reverb on 128
    (each >= 0.98);
21. the speech host (``speech_host(12.0, rng=default_rng(77))`` embedded
    in 1024-sample ``process`` calls): clean (>= 0.80) and MP3-sim at
    B = 1024, reverb on 128, the real Layer III codec at 128 kbps on 32,
    +3.1 % speed through ``verify_batch_recover`` on 128, a wrong key at
    1024 (0.0); each row beside the JAX package's TPU number;
22. real codecs in the geometry of ``benchmarks/codec_envelope.py``: 4 s
    cuts of a 700 Hz host, 16 draws (8 on a host with fewer than 16
    cores) through mu-law, A-law, IMA ADPCM, ``ratecv`` to 44.1 kHz,
    Layer II and Layer III at 64 and 128 kbps; each row through
    ``RobustVerifier`` clip by clip (all but one draw must verify) and 2
    draws under a wrong key (none may), then all of them through
    ``RobustBatchVerifier.verify_batch`` as one batch per capture rate;
23. 4 clips each of tone-host MP3-sim, tone-host reverb and speech-host
    clean through ``RobustBatchVerifier`` on the card and on the CPU:
    verdicts and accepting stage row-identical; on the card
    ``frozen_check.audit()``, ``pn_check``, ``polar_roundtrip`` (16
    trials, L = 8), and ``stage_compare`` (v2 through MP3-sim, compat)
    against its CPU run: bools, integers and strings equal, floats within
    1e-3 (compat demod, header and LLR scores 0.01);
24. native TX and the GUI verify: the C ring mixer must build
    (``native.available()``); a seeded ``NativeStreamEmbedder`` renders
    8 s in 1024-sample blocks with the ring stocked before each block
    (``process`` p50/p99 µs, host clock of the card machine's CPU) and
    ``WatermarkDetector(KEY)`` on the card must verify it; ``tx_app
    --native`` offline in a subprocess, its WAV verified by ``rx_app``
    on the card; ``RxGUI()`` (stubbed tkinter) verifies the same WAV on
    its worker thread on the card: ``AUTHENTIC``;
25. data parallelism: an in-process world-size-1 ``nccl`` group on
    ``cuda:0``; ``shard_verify`` on the phase-4 clips and
    ``shard_verify_v2`` on 1024 cuts of the phase-7 stream: integers and
    bools equal to the unsharded ``run_device``, floats within 1e-5 of
    each clip's largest, the all-reduced ``n_crc_ok`` equal to the
    unsharded count, verdicts row-identical, accept 1.0; the sharded and
    unsharded RTF (stage + host finish, best of 3, in turns); then
    ``python -m echoseal_torch.parallel.dryrun 1`` on ``nccl`` must print
    ``DRYRUN_OK ... recovered=1``.
26. the fast-SSCL serving decoder (phases 1-25 run the exact one, the
    ``ECHOSEAL_SCL_*`` switches unset; each leg here sets its switch in
    ``scl_env``, which restores the environment).  Every serving leg must
    launch ``scl_serving``, never ``scl_decode``, and run no eager walk on
    the card (``no_card_walk``); every exact leg must launch no
    ``scl_serving``: (a) 256 rows per spec
    at sigma 0.35 at L = 8 and 32, and phase 10's 128 compat rows at
    L = 256, exact and serving in turns (exact, serving, serving, exact,
    exact, serving), each decode one launch, decodes/s of each (best run),
    the aten ops one decode dispatches and the first-CRC-pass FER, the
    serving FER at most
    the exact FER plus ``benchmarks/scl_sweep.py``'s binomial slack, and
    8 rows per (spec, L) with the CRC-passing sets of the CPU's serving
    decode; (b) phase 9's 1024 clips through ``verify_batch`` with
    ``ECHOSEAL_SCL_SERVING`` unset and ``"1"`` in turns: both accepts and
    seconds, the clips rescued by ``"scl"`` and the rungs of each run (one
    ``scl_serving`` launch per serving rung); the serving
    accept at least the hard accept and the exact accept less the slack,
    the first 16 verdicts equal to the CPU's serving ladder, and every clip
    rejected under a wrong key; (c) phase 14's batch through
    ``verify_batch_recover`` with ``ECHOSEAL_SCL_SERVING=1`` (accept
    >= 0.95), seconds and SCL share per round beside phase 14's second
    call; (d) a noise clip through a fresh compat ``WatermarkDetector(KEY)``
    and a fresh ``RobustVerifier(KEY)``, exact and with
    ``ECHOSEAL_SCL_IMPL=serving`` in turns: rejected, seconds and SCL
    seconds of each run beside phase 16's exact rejected clip; then an
    authentic cut of each tier under serving must verify.

The host impairments of phases 20-22 run in a pool of ``os.cpu_count()``
worker processes (one BLAS thread each), every row's jobs queued at the
start of phase 20, so later rows are staged while the card verifies
earlier ones; the diagnostics of phase 23, which need no staging, run
first, while the workers start.  Each row prints its accept rate, ``n``,
verify seconds, audio seconds per second, the SCL rungs' seconds, kernel
launches, peak memory, the workers' summed staging seconds and the
seconds the row waited for them.

Every exact list decode on the card is one launch of ``scl_decode``; the
runs of phases 7, 9, 10, 14, 16, 17 and 20-22 add theirs to a path
(``SCL_BY_PATH``), and the ladder (9), SCL-256 (10), recovery (14), the
rejected compat clips (16), the v2 noise clip's SCL pass (17) and the
failing impaired v2 rows (20-21) must each have launched it; phase 26's
serving legs must launch it never, its exact legs count theirs.  Every
serving decode on the card is one launch of ``scl_serving``: phase 26's
decoder, ladder, recovery and single-clip legs add theirs to a path
(``SERVING_BY_PATH``), and each must have launched it.  Phase 14's
recovery call must launch ``scale_scan`` once per scan chunk and
``resample`` once per lattice group (one a ``recover.resample`` span,
which carries ``launches``); phase 13's ingest call ``resample`` once.

Before the last line it prints ``{"kernels": [...]}``: each kernel at the
v2 path's shape (``scl_decode`` and ``scl_serving`` at the ladder's first
rung), with its launches counted over every main path (each path driven
with the counts set to 0 just before it): ``payload_decode`` on every main
path, which launches ``payload_llr`` no more, ``payload_llr`` in phase
23's diagnostics, ``scl_decode`` and ``scl_serving`` by path.  The last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import shared_memory
from pathlib import Path

import numpy as np

KEY = bytes.fromhex("aa" * 32)
BAD_KEY = bytes.fromhex("99" * 32)
FS = 48_000
B = 1024
CLIP_S = 3
T = CLIP_S * FS
TPAD = T + 8192
TPAD_V2 = T + 16_384
STREAM_FRAMES = 4096
STREAM_S_V2 = 12
MAX_CTR = 16_384
PEAKS = 2
V2_PEAKS = 4
V2_NP = 2                     # lam profiles of the v2 LS demod
SEED = 0
COMPAT_SCALE = 10.0 ** (-35.0 / 20.0)   # phase 4's clips: 35 dB down
KERNEL_TOL = 1e-4
N_CPU_LADDER = 16             # SCL-ladder clips re-verified on the CPU
N_SCL256 = 128
N_CPU_SCL256 = 8
T35 = int(3.5 * FS)           # clip length of the ingest and recovery phases
TPAD_44K = 169_344            # 147 * 1152: ingests to exactly TPAD_REC
TPAD_REC = 184_320            # 160 * 1152 = 4096 * 45
SCALE = 1.031                 # the time-scale row: played 3.1 % fast
MIXED_FACTORS = (0.953, 0.978, 1.0, 1.031, 1.047)
N_MIXED = 64
N_TX_CLIPS = 64
N_SINGLE = 30                 # cuts per single-clip tier
N_POOL_CLIPS = 256
N_DEVICE_PAIR = 4             # clips per tier verified on the card and the CPU
RESULT_FIELDS = ("authentic", "frame_ctr", "band", "peak_pos", "stage",
                 "session_nonce", "timescale")
TX_TOL = 2e-5
RESAMPLE_TOL = 1e-5
RECOVER_GATE = 0.95
MIXED_GATE = 0.9
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12      # dense tensor cores, fp32 accumulators
# phase 3e: the v2 cells' benchmark seeds whose batch 0 the sync kernel
# reads, and a recovery round's rows (TPAD_REC wide)
SYNC_SEEDS = (2147483901, 3000000011)
SYNC_REC_ROWS = 96
SYNC_TOL = 1e-5
# phase 3f: scores of the scan kernel against its plain version
SCAN_TOL = 1e-5
# exp and log1p: 16 SFU results per SM per clock, 132 SMs, 1.98 GHz boost
# (H100 SXM, the Hopper architecture white paper)
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# phase 3c's shapes (spec, rows, L, sigma): phase 10's SCL-256, the compat
# single clip's batch, the v2 single clip's rows, the v2 ladder's rungs
# (1024 and 321 rows at L = 8, 107 at L = 32: phase 9's rungs), and a
# compat single clip's batch at `rx_app --list-size 512`
SCL_SHAPES = (("compat", 128, 256, 0.3), ("compat", 32, 256, 0.35),
              ("v2", 32, 32, 0.35), ("v2", 1024, 8, 0.35),
              ("v2", 321, 8, 0.35), ("v2", 107, 32, 0.35),
              ("compat", 32, 512, 0.35))
SCL_TOL = 1e-4
# phase 3d's shapes (spec, rows, L, block_seg): the serving ladder's rungs
# (1024 and 321 rows at L = 8, 107 at L = 32), a compat single clip's
# batches at L = 256 and 32, 16-leaf nodes and 64-leaf ones
SERVING_SHAPES = (("v2", 1024, 8, 16), ("v2", 321, 8, 16),
                  ("v2", 107, 32, 16), ("compat", 128, 256, 16),
                  ("compat", 32, 32, 16), ("v2", 321, 8, 8),
                  ("compat", 128, 32, 64))
# paths whose run must have launched scl_decode
SCL_PATHS = ("scl_ladder", "scl256", "timescale_recover",
             "compat_single_rejected", "v2_single_noise", "impaired_v2_tone",
             "impaired_v2_speech")
# phase 26's serving paths, each of which must have launched scl_serving
SERVING_PATHS = ("serving_decoder", "serving_ladder", "serving_recover",
                 "serving_single")
BUSY_US = 200.0               # phase 3: card kept busy this long per launch
N_SUB = 128                   # reverb and speech time-scale sub-batches
N_L3 = 32                     # speech host through the real Layer III codec
IMPAIRED_GATE = 0.98          # tone-host v2: MP3-sim, reverb, wm+6 dB AWGN
SPEECH_GATE = 0.80            # speech-host v2, clean
CODEC_T = 4 * FS              # codec rows: 4 s clips (codec_envelope.py)
CODEC_DRAWS = 16 if (os.cpu_count() or 1) >= 16 else 8
N_WRONG_DRAWS = 2             # codec draws per row verified under a wrong key
CODEC_WIDTH = {48_000: 204_800, 44_100: 188_160}   # 188 160 ingests to 204 800
NATIVE_S = 8                  # seconds of native-mixer TX (phase 24)
SCL_SWITCHES = ("ECHOSEAL_SCL_IMPL", "ECHOSEAL_SCL_SERVING",
                "ECHOSEAL_SCL_BLOCK_SEG")
N_SERVING_ROWS = 256          # phase 26: rows per spec at the waterfall point
SERVING_SIGMA = 0.35          # benchmarks/scl_sweep.py's waterfall sigma
TURNS = ("exact", "serving", "serving", "exact", "exact", "serving")
N_CPU_SERVING = 8             # rows per (spec, L) decoded on the CPU too
ROOT = Path(__file__).resolve().parent
CODECS = (("ulaw", "ulaw", None), ("alaw", "alaw", None),
          ("adpcm", "adpcm", None), ("ratecv_44k1_capture", "ratecv", 44_100),
          ("mpeg1_l2@64k", "l2", 64), ("mpeg1_l2@128k", "l2", 128),
          ("mpeg1_l3@64k", "l3", 64), ("mpeg1_l3@128k", "l3", 128))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
        raise SystemExit(1)


def decode_launches(launches) -> int:
    """payload_decode's launches in ``launches`` (one path's counts from 0),
    after checking that the path launched payload_llr no more."""
    check(launches.get("payload_llr", 0) == 0,
          f"payload_llr launched on a main path: {dict(launches)}")
    return launches.get("payload_decode", 0)


# path -> scl_decode launches of its runs (each run counted from 0)
SCL_BY_PATH: dict[str, int] = {}


def scl_launches(path: str, launches) -> int:
    """Add one run's scl_decode launches (its counts from 0) to ``path``."""
    n = launches.get("scl_decode", 0)
    SCL_BY_PATH[path] = SCL_BY_PATH.get(path, 0) + n
    return n


# path -> scl_serving launches of its runs (phase 26's serving legs)
SERVING_BY_PATH: dict[str, int] = {}
# path -> sync_xcorr launches of one verify_batch (phases 4 and 7)
SYNC_BY_PATH: dict[str, int] = {}
# path -> scale_scan launches of one recovery call (phase 14)
SCAN_BY_PATH: dict[str, int] = {}
# path -> resample launches of one ingest call (13) and recovery call (14)
RESAMPLE_BY_PATH: dict[str, int] = {}


def serving_launches(path: str, launches, least: int = 1) -> int:
    """Add one serving run's scl_serving launches (its counts from 0) to
    ``path``, after checking that it launched the exact kernel never and
    the serving kernel at least ``least`` times."""
    n = launches.get("scl_serving", 0)
    check(launches.get("scl_decode", 0) == 0 and n >= least,
          f"serving run on {path}: {dict(launches)}")
    SERVING_BY_PATH[path] = SERVING_BY_PATH.get(path, 0) + n
    return n


@contextlib.contextmanager
def no_card_walk():
    """Fail if a list decode of a card tensor takes the eager walk inside
    the block: on the card every decode, exact or serving, is one kernel
    launch."""
    from echoseal_torch.ops import scl

    real, seen = scl._walk_decode, []

    def spy(llr, *args, **kwargs):
        if llr.device.type != "cpu":
            seen.append(tuple(llr.shape))
        return real(llr, *args, **kwargs)

    scl._walk_decode = spy
    try:
        yield
    finally:
        scl._walk_decode = real
    check(not seen, f"the eager walk ran on the card: {seen}")


def busy_cycles(torch, us: float = BUSY_US) -> tuple[int, float]:
    """``torch.cuda._sleep`` cycles that keep the card busy ``us`` µs.

    The sleep kernel spins on the SM clock, so the cycles per µs are the
    clock's MHz: read here from one timed 10**7-cycle sleep.  Returns
    (cycles, the measured MHz).
    """
    torch.cuda._sleep(1000)                     # load the kernel
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    torch.cuda.synchronize()
    mhz = 10 ** 7 / (a.elapsed_time(b) * 1e3)
    return int(us * mhz), mhz


def cuda_ms(fn, torch, n: int = 25, flush=None, busy: int = 0) -> float:
    """Median CUDA-event time of ``fn`` over ``n`` launches (after a warm-up).

    With ``busy`` cycles, a ``torch.cuda._sleep`` is queued before the
    start event, so the card is still busy while the host runs ``fn``'s
    Python and launch path: the event pair then brackets the device work
    alone, not the host's way to it.
    """
    fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()              # evict L2 (50 MB) between launches
        if busy:
            torch.cuda._sleep(busy)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn, torch, n: int = 25) -> float:
    """Median host-clock µs of ``fn`` returning (its launch path; the
    card drained between calls)."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def stage_ms(start, marks) -> dict[str, float]:
    """CUDA-event ms of each marked stage, from ``start`` on."""
    prev, out = start, {}
    for nm, ev in marks:
        out[nm] = prev.elapsed_time(ev)
        prev = ev
    out["sync"] = out["sync_xcorr"] + out["sync_nms"]
    return out


def kernel_phase(torch, llr, flush, busy, mhz):
    """Phase 3a: payload_llr vs its plain version at every path's shape.

    Returns (max error over all shapes, the v2-shape ``kernels`` entry).
    """
    from echoseal_torch.core.params import FRAME_LEN

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entry, max_err = None, 0.0
    for lead in ((13,), (37,), (800,), (B, 4, PEAKS), (B, 4, V2_NP, V2_PEAKS)):
        chips = 0.05 * torch.randn(*lead, FRAME_LEN, device="cuda",
                                   generator=gen)
        pn = torch.randint(0, 2, (*lead, 1024), device="cuda",
                           generator=gen).float() * 2.0 - 1.0
        got = llr.payload_llr(chips, pn)
        want = llr.payload_llr_plain(chips, pn)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        check(err <= KERNEL_TOL, f"payload_llr at {lead}: max err {err}")
        n = int(np.prod(lead))
        line = {"phase": "kernel_check", "name": "payload_llr", "rows": n,
                "shape": list(lead) + [FRAME_LEN], "max_abs_err": err}
        if n > 13:
            n_bytes = 3 * n * 1024 * 4          # chips + pn read, llr written
            n_ops = 12 * n * 1024               # ~12 fp32 ops per element
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = n_ops / FP32_FLOP_PER_S * 1e3
            launch_us = host_us(lambda: llr.payload_llr(chips, pn), torch)
            line.update(
                ms=cuda_ms(lambda: llr.payload_llr(chips, pn), torch,
                           flush=flush, busy=busy),
                plain_ms=cuda_ms(lambda: llr.payload_llr_plain(chips, pn),
                                 torch, flush=flush, busy=busy),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                launch_host_us=launch_us,
                busy_us=BUSY_US, busy_cycles=busy, sm_mhz_measured=mhz,
                queue_kept_busy=launch_us < BUSY_US)
        emit(line)
        if len(lead) == 4:
            entry = {
                "name": "payload_llr", "route": "cuda",
                "source": "echoseal_torch/csrc/payload_llr.cu",
                "replaces": "echoseal_tpu/ops/pallas/llr_kernel.py:51",
                "launches": None, "max_abs_err": None,
                **{k: line[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
                "library_ms": None,
            }
    return max_err, entry


def _sync_cases(torch):
    """Phase 3e's inputs: (name, clips, n_valid).

    Batch 0 of each v2 cell of the benchmark at SYNC_SEEDS (1024 rows of
    T + 16 384), a recovery round's rows (SYNC_REC_ROWS of TPAD_REC, odd
    lengths, some shorter than a frame, int64 lengths) and ragged small
    shapes: one row, T = L, rows below a frame.
    """
    from portbench import gen, harness

    cases = []
    for cell in ("v2.batch-clean", "v2.batch-mp3"):
        c = harness.load_cell(cell)
        for seed in SYNC_SEEDS:
            _, batches = gen.make_batches(c["config"], c["traffic"], seed,
                                          "cuda")
            cases.append((f"{cell}:{seed}", batches[0].clips,
                          batches[0].n_valid))
    clips0 = cases[0][1]
    rng = np.random.default_rng(SEED + 30)
    rec = torch.zeros(SYNC_REC_ROWS, TPAD_REC, device="cuda")
    nv = rng.integers(int(0.97 * T35), TPAD_REC, SYNC_REC_ROWS) | 1
    nv[:4] = (9000, 9719, 9720, 9721)        # below, at and past one frame
    for i, n in enumerate(nv):
        k = min(int(n), clips0.shape[1])
        rec[i, :k] = clips0[i % clips0.shape[0], :k]
    cases.append(("recover_round", rec, torch.from_numpy(nv).cuda()))
    for rows, width in ((1, 20_011), (3, 504), (17, 9_999)):
        x = 0.1 * torch.randn(rows, width, device="cuda")
        n = torch.full((rows,), width, dtype=torch.int32, device="cuda")
        cases.append((f"ragged_{rows}x{width}", x, n))
    return cases


def sync_kernel_phase(torch, flush, busy):
    """Phase 3e: the v2 sync kernel against its plain version.

    Each case of ``_sync_cases``: corr within SYNC_TOL of
    ``demod.sync_xcorr_plain``, -inf at exactly the lags past
    ``n_valid - span``, and the v2 stage's NMS peaks (4 a band) at the same
    lags except where the plain version's two lags tie within twice the
    case's error (ties, counted).  At the main path's shape and the
    recovery round's: the kernel's, the plain version's and cuDNN's
    (``normalized_xcorr`` in bf16 and the mask: the yardstick,
    ``library_ms``) CUDA-event times, median of 25 with L2 flushed, and
    the bound: 2 * 5 * L operations a valid lag at BF16_FLOP_PER_S against
    the rows read and corr written at HBM_BYTES_PER_S.  Returns (max error,
    the ``kernels`` entry).
    """
    from echoseal_torch.core.profiles import ROBUST
    from echoseal_torch.models import robust
    from echoseal_torch.ops import demod

    torch.backends.cuda.matmul.allow_tf32 = False    # as the verifiers
    torch.backends.cudnn.allow_tf32 = False
    span = ROBUST.span
    tpl = torch.from_numpy(robust.robust_templates(FS, ROBUST.oversample)
                           ).cuda()
    L = tpl.shape[-1]

    def library(x, nv):
        corr = demod.normalized_xcorr(x, tpl, compute_dtype=torch.bfloat16)
        lag = torch.arange(corr.shape[-1], device="cuda")
        return corr.masked_fill_(lag > (nv[:, None, None] - span),
                                 float("-inf"))

    entry, max_err = None, 0.0
    for name, x, nv in _sync_cases(torch):
        got = demod.sync_xcorr(x, tpl, nv, span)
        want = demod.sync_xcorr_plain(x, tpl, nv, span)
        torch.cuda.synchronize()
        n_out = x.shape[1] - L + 1
        lag = torch.arange(n_out, device="cuda")
        bad = (lag > (nv.long()[:, None] - span))[:, None, :].expand_as(got)
        check(torch.equal(torch.isneginf(got), bad)
              and torch.equal(torch.isneginf(want), bad),
              f"sync_xcorr {name}: -inf off the masked lags")
        err = float((got - want)[~bad].abs().max()) if (~bad).any() else 0.0
        check(err <= SYNC_TOL, f"sync_xcorr {name}: max err {err}")
        max_err = max(max_err, err)
        line = {"phase": "kernel_check", "name": "sync_xcorr", "case": name,
                "shape": list(x.shape), "L": L, "span": span,
                "max_abs_err": err}
        if n_out >= span // 2:
            gi, _ = demod.topk_nms(got, V2_PEAKS, span // 2)
            wi, _ = demod.topk_nms(want, V2_PEAKS, span // 2)
            diff = (gi != wi).nonzero().tolist()
            for r, b, k in diff:
                a, w = int(gi[r, b, k]), int(wi[r, b, k])
                gap = abs(float(want[r, b, a]) - float(want[r, b, w]))
                check(gap <= 2 * err,
                      f"sync_xcorr {name}: peak {r, b, k} at {a}, plain "
                      f"{w}, gap {gap}")
            line.update(peaks=int(gi.numel()), peak_ties=len(diff))
        if x.shape[0] >= SYNC_REC_ROWS and name in (
                f"v2.batch-clean:{SYNC_SEEDS[0]}", "recover_round"):
            valid = torch.clamp(nv.long() - span + 1, 0, n_out).sum()
            n_ops = 2 * 5 * L * int(valid)
            n_bytes = 4 * x.numel() + 4 * got.numel()
            t_ops = n_ops / BF16_FLOP_PER_S * 1e3
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            line.update(
                ms=cuda_ms(lambda: demod.sync_xcorr(x, tpl, nv, span), torch,
                           flush=flush, busy=busy),
                plain_ms=cuda_ms(
                    lambda: demod.sync_xcorr_plain(x, tpl, nv, span), torch,
                    flush=flush, busy=busy),
                library_ms=cuda_ms(lambda: library(x, nv), torch,
                                   flush=flush, busy=busy),
                bound_ms=max(t_ops, t_bytes), ops_ms=t_ops,
                bytes_ms=t_bytes,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                valid_lags=int(valid))
            if entry is None:
                entry = {
                    "name": "sync_xcorr", "route": "cuda",
                    "source": "echoseal_torch/csrc/sync_xcorr.cu",
                    "replaces": "echoseal_tpu/ops/demod.py:202 (XLA "
                                "convolutions; no Pallas kernel)",
                    "launches": None, "max_abs_err": None,
                    **{k: line[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}}
        emit(line)
        del got, want
    return max_err, entry


def _cufft_scan(torch, x, n_valid, bank, row_chunk=4):
    """The full-length cuFFT scan ``scale_scan`` replaced (its yardstick):
    per 4-row chunk of the bank a (B, 4, T) correlation cube divided,
    masked and reduced in device memory."""
    from echoseal_torch.models import robust

    Bn, Tn = x.shape
    R, L = bank.shape
    n_lag = Tn - L + 1
    X = torch.fft.rfft(x)
    energy = robust._window_energy(x, L)
    lag = torch.arange(n_lag, device=x.device)
    bad = lag[None, :] > (n_valid.long()[:, None] - L)
    Bf = torch.conj(torch.fft.rfft(bank, Tn))
    scores = []
    for r0 in range(0, R, row_chunk):
        corr = torch.fft.irfft(X[:, None, :] * Bf[None, r0:r0 + row_chunk],
                               Tn, dim=-1)[..., :n_lag]
        corr.div_(energy[:, None, :])
        corr.masked_fill_(bad[:, None, :], float("-inf"))
        scores.append(corr.amax(dim=-1))
    return torch.cat(scores, dim=1)


def _scan_work(nv: np.ndarray, width: int, L: int, R: int):
    """(fp32 operations, bytes) the scan needs: per pair of segments with a
    valid lag, one N-point complex FFT and R inverse ones (5 N log2 N
    each), R spectral products (6 N) and 2 H normalised maxima (2 each);
    the rows and the energies read once."""
    from echoseal_torch.models import robust

    n = robust.SCAN_FFT_LEN
    H = n - L + 1
    lim = np.minimum(nv.astype(np.int64), width) - L
    segs = np.where(lim >= 0, lim // H + 1, 0)
    pairs = int(((segs + 1) // 2).sum())
    ops = pairs * ((R + 1) * 5 * n * np.log2(n) + R * (6 * n + 4 * H))
    n_bytes = 4 * len(nv) * (width + width - L + 1)
    return float(ops), n_bytes, pairs


def scan_kernel_phase(torch, flush, busy):
    """Phase 3f: the time-scale scan kernel against its plain version.

    Returns (max error over the cases, the ``kernels`` entry).
    """
    from echoseal_torch.core.profiles import ROBUST
    from echoseal_torch.models import robust
    from echoseal_torch.models.pipeline import RobustBatchVerifier
    from portbench import gen, harness

    bank = robust.device_scan_bank(
        robust.scaled_template_bank(FS, ROBUST.oversample), "cuda")
    R, L = bank.shape
    c = harness.load_cell("v2.recover-timescale")
    _, batches = gen.make_batches(c["config"], c["traffic"], SYNC_SEEDS[0],
                                  "cuda")
    chunk = RobustBatchVerifier.SCAN_CHUNK
    clips, nv = batches[0].clips[:chunk], batches[0].n_valid[:chunk]
    one = torch.zeros(1, 1 << 18, device="cuda")
    one[0, :T35] = clips[0, :T35]
    rng = np.random.default_rng(SEED + 31)
    rag_nv = rng.integers(L, TPAD_REC, 17)
    rag_nv[:3] = (L - 1, L, 9_000)
    cases = [("recover_chunk", clips, nv),
             ("single_clip", one, torch.tensor([T35], device="cuda")),
             ("ragged", clips[:17, :TPAD_REC].contiguous(),
              torch.from_numpy(rag_nv).cuda())]
    del batches
    grid = np.asarray(robust.SCALE_SCAN_GRID)
    entry, max_err = None, 0.0
    for name, x, n in cases:
        got = robust._scale_scan_batch(x, n, bank)
        want = robust.scale_scan_plain(x, n, bank)
        torch.cuda.synchronize()
        check(torch.equal(torch.isneginf(got), torch.isneginf(want))
              and not torch.isnan(got).any(),
              f"scale_scan {name}: -inf off the plain version's")
        fin = torch.isfinite(want)
        err = float((got - want)[fin].abs().max()) if fin.any() else 0.0
        check(err <= SCAN_TOL, f"scale_scan {name}: max err {err}")
        max_err = max(max_err, err)
        g = got.cpu().numpy().reshape(-1, grid.size, 4).max(-1)
        w = want.cpu().numpy().reshape(-1, grid.size, 4).max(-1)
        ties = 0
        for i in np.flatnonzero(g.argmax(1) != w.argmax(1)):
            gap = abs(w[i, g[i].argmax()] - w[i, w[i].argmax()])
            check(gap <= 2 * err, f"scale_scan {name}: clip {i} picks "
                  f"{grid[g[i].argmax()]}, plain {grid[w[i].argmax()]}")
            ties += 1
        line = {"phase": "kernel_check", "name": "scale_scan", "case": name,
                "shape": list(x.shape), "rows": R, "L": L,
                "n_fft": robust.SCAN_FFT_LEN, "max_abs_err": err,
                "pick_ties": ties}
        if name != "ragged":
            n_ops, n_bytes, pairs = _scan_work(n.cpu().numpy(), x.shape[1],
                                               L, R)
            t_ops = n_ops / FP32_FLOP_PER_S * 1e3
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            line.update(
                ms=cuda_ms(lambda: robust._scale_scan_batch(x, n, bank),
                           torch, flush=flush, busy=busy),
                plain_ms=cuda_ms(lambda: robust.scale_scan_plain(x, n, bank),
                                 torch, n=5, flush=flush, busy=busy),
                library_ms=cuda_ms(lambda: _cufft_scan(torch, x, n, bank),
                                   torch, n=5, flush=flush, busy=busy),
                bound_ms=max(t_ops, t_bytes), ops_ms=t_ops, bytes_ms=t_bytes,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                pairs=pairs)
            if entry is None:
                entry = {
                    "name": "scale_scan", "route": "cuda",
                    "source": "echoseal_torch/csrc/scale_scan.cu",
                    "replaces": "echoseal_tpu/models/robust.py:179 (jnp.fft; "
                                "no Pallas kernel)",
                    "launches": None, "max_abs_err": None,
                    **{k: line[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}}
        emit(line)
        del got, want
    return max_err, entry


# the recovery's retried rows a 1024-clip call of the benchmark cell, at its
# clip width and the lattice key of the 3.1 % factor
RS_ROWS, RS_T, RS_DEN = 1_125, 184_384, 11_640


def resample_kernel_phase(torch, flush, busy):
    """Phase 3g: the resample kernel against the parent's torch loop.

    Returns (the relative error, the ``kernels`` entry).
    """
    from echoseal_torch.models.pipeline import RobustBatchVerifier as V
    from echoseal_torch.ops import resample as pr

    lo, hi = V.RETRY_REACH
    rs = pr.DeviceResampler(V.RETRY_UP, int(V.RETRY_UP * lo) - 4,
                            int(V.RETRY_UP * hi) + 4, RS_T, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 37)
    x = torch.randn(RS_ROWS, RS_T, device="cuda", generator=g)
    taps, off, s0 = rs._plan_dev(RS_DEN)
    up, k_taps = taps.shape
    n_out = -(-RS_T * up // RS_DEN)

    def kernel():
        return rs(x, RS_DEN, width=RS_T)[0]

    def plain():      # the torch loop every card resample ran before
        return pr._resample_stage(x, taps, off, s0, RS_DEN,
                                  min(n_out, rs.n_blocks * up),
                                  n_blocks=rs.n_blocks,
                                  pad_left=rs.pad_left)[:, :RS_T]

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    check(err <= RESAMPLE_TOL, f"resample kernel vs its torch loop: {err}")
    del got, want
    # each row's input as far as the kept outputs reach it, read once, and
    # its kept outputs written once
    reach = min(RS_T, -(-RS_T * RS_DEN // up) + k_taps)
    t_bytes = 4 * RS_ROWS * (reach + RS_T) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * k_taps * RS_ROWS * RS_T / FP32_FLOP_PER_S * 1e3
    line = {"phase": "kernel_check", "name": "resample", "rows": RS_ROWS,
            "t_in": RS_T, "width": RS_T, "up": up, "down": RS_DEN,
            "k_taps": k_taps, "rel_err": err,
            "ms": cuda_ms(kernel, torch, flush=flush, busy=busy),
            "plain_ms": cuda_ms(plain, torch, n=5, flush=flush, busy=busy),
            "bound_ms": max(t_bytes, t_ops), "ops_ms": t_ops,
            "bytes_ms": t_bytes,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit(line)
    entry = {"name": "resample", "route": "cuda",
             "source": "echoseal_torch/csrc/resample.cu",
             "replaces": "echoseal_tpu/ops/resample.py:_resample_stage "
                         "(XLA; no Pallas kernel)",
             "launches": None, "max_abs_err": None,
             **{k: line[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by")}}
    del x
    return err, entry


def host_sync_ms(fn, torch, n: int = 25) -> float:
    """Median host-clock ms of ``fn`` and a synchronise: a call's cost to
    its caller, launches and device work both."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def _decode_inputs(torch, lead, spec, gen):
    """Chips carrying real codewords of ``spec`` under noise rising along
    the rows (the low-noise rows pass the CRC), a PN bit table and each
    row's index.  At batch row counts the table is the batch tier's: int8,
    MAX_CTR rows, int32 counters; at single-clip row counts the tiers':
    uint8 rows of the distinct counters, int64 indices."""
    from echoseal_torch.core.params import FRAME_LEN, HDR_L, PRE_L
    from echoseal_torch.ops.polar import encode_np

    n = int(np.prod(lead))
    rng = np.random.default_rng(SEED + 11)
    book = torch.from_numpy(np.stack([
        encode_np(rng.bytes(spec.info_len // 8), spec)
        for _ in range(16)])).cuda().float()
    batch = n >= 8192
    m = MAX_CTR if batch else n // 2 + 1
    table = torch.randint(0, 2, (m, 1024), device="cuda", generator=gen,
                          dtype=torch.int8 if batch else torch.uint8)
    idx = torch.randint(0, m, (n,), device="cuda", generator=gen,
                        dtype=torch.int32 if batch else torch.int64)
    pick = torch.randint(0, 16, (n,), device="cuda", generator=gen)
    sent = (2.0 * book[pick] - 1.0) * (2.0 * table[idx.long()].float() - 1.0)
    sigma = torch.linspace(0.05, 1.6, n, device="cuda")[:, None]
    chips = 0.05 * torch.randn(n, FRAME_LEN, device="cuda", generator=gen)
    chips[:, PRE_L + HDR_L:] = 0.05 * (sent + sigma * torch.randn(
        n, 1024, device="cuda", generator=gen))
    return chips.reshape(*lead, FRAME_LEN), table, idx.reshape(lead)


def decode_kernel_phase(torch, llr, flush, busy):
    """Phase 3b: payload_decode vs its plain version, and beside the chain
    it replaces, at every path's row count.

    13, 37, 800 and 8192 rows (compat spec, no LLRs) and the v2 lattice of
    32 768 rows (the v2 spec, with LLRs), on inputs with CRC-passing rows:
    info bits and crc_ok exact, LLRs (a launch with LLRs at every row
    count) within rtol = atol = KERNEL_TOL, the contract of the TPU
    kernel's own test.  An absolute bound does not hold on such rows: the
    LLRs reach +-16 and, where the amplitude estimate a nears 1, s2 = 1 - a^2
    magnifies the rounding of the row sums ~30-fold, so two float32 orders
    of summation differ by ~1e-4.  Each line gives both float32 versions'
    distance from the plain version in float64 (``f64_max_abs_err``: the
    largest and the rms), and the kernel must stay as accurate as the plain
    version: its rms at most twice the plain one's at every row count, its
    largest at most twice the plain one's over all of them (a largest
    over a few rows depends on which rows near the amplitude clip).
    ``bound_ms`` counts each input byte once: the PN bytes of the distinct
    table rows the indices name (``pn_rows_read``), not one row per chip
    row.  Device times with the busy harness, in turns:
    the kernel (``ms``) and ``payload_llr`` alone at these rows; then its
    plain version and ``floor_ms``, a one-element add (the launch floor).
    Host clock with a synchronise per call, in turns: the kernel's wrapper
    (``call_ms``), the chain it replaces (``chain_ms``: PN gather,
    ``payload_llr``, ``hard_decode_batch``) and that chain with the two
    table uploads per call that ``hard_decode_batch`` made before the
    per-device cache (``chain_uploads_ms``).  Returns (max LLR error, the
    v2-row ``kernels`` entry).
    """
    from echoseal_torch.core.params import FRAME_LEN
    from echoseal_torch.core.profiles import ROBUST, profile_spec
    from echoseal_torch.ops.polar import hard_decode_batch, polar_spec

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    one = torch.zeros(1, device="cuda")
    entry, max_err = None, 0.0
    f64_max = {"kernel": 0.0, "plain": 0.0}
    for lead in ((13,), (37,), (800,), (B, 4, PEAKS), (B, 4, V2_NP, V2_PEAKS)):
        v2 = len(lead) == 4
        spec = profile_spec(ROBUST) if v2 else polar_spec()
        chips, table, idx = _decode_inputs(torch, lead, spec, gen)
        full = llr.payload_decode(chips, table, idx, spec, want_llr=True)
        got = llr.payload_decode(chips, table, idx, spec, want_llr=v2)
        ref = llr.payload_decode_plain(chips, table, idx, spec, want_llr=True)
        exact64 = llr.payload_decode_plain(chips.double(), table, idx, spec,
                                           want_llr=True)[0]
        torch.cuda.synchronize()
        n = int(np.prod(lead))
        diff = (full[0] - ref[0]).abs()
        err = float(diff.max())
        tol_used = float((diff / (KERNEL_TOL * (1.0 + ref[0].abs()))).max())
        f64_err = {}
        for who, x in (("kernel", full[0]), ("plain", ref[0])):
            d64 = x - exact64
            f64_err[who] = float(d64.abs().max())
            f64_err[who + "_rms"] = float(d64.square().mean().sqrt())
            f64_max[who] = max(f64_max[who], f64_err[who])
        check(f64_err["kernel_rms"] <= 2.0 * f64_err["plain_rms"],
              f"payload_decode at {lead}: float64 distance {f64_err}, the "
              "kernel's rms over twice the plain version's")
        exact = all(torch.equal(a[i], ref[i]) for a in (full, got)
                    for i in (1, 2))
        n_pass = int(ref[2].sum())
        max_err = max(max_err, err)
        check(tol_used <= 1.0 and exact,
              f"payload_decode at {lead}: LLR err {err} ({tol_used} of the "
              f"tolerance), info and crc_ok exact {exact}")
        check(0 < n_pass < n, f"payload_decode at {lead}: {n_pass} of {n} "
                              "rows pass the CRC")
        del full, got, ref, exact64, diff

        def kernel():
            llr.payload_decode(chips, table, idx, spec, want_llr=v2)

        def plain():
            llr.payload_decode_plain(chips, table, idx, spec, want_llr=v2)

        pn_sy = 2.0 * table[idx.long()].float() - 1.0

        def llr_alone():
            llr.payload_llr(chips, pn_sy)

        def chain():
            hard_decode_batch(llr.payload_llr(
                chips, 2.0 * table[idx.long()].float() - 1.0), spec)

        def chain_uploads():
            torch.as_tensor(spec.data_pos, device="cuda")
            torch.as_tensor(spec.crc_mat, dtype=torch.float32, device="cuda")
            chain()

        dev = {"ms": [], "payload_llr_ms": []}
        for name, fn in (("ms", kernel), ("payload_llr_ms", llr_alone),
                         ("payload_llr_ms", llr_alone), ("ms", kernel)):
            dev[name].append(cuda_ms(fn, torch, flush=flush, busy=busy))
        call = {"call_ms": [], "chain_ms": [], "chain_uploads_ms": []}
        for name, fn in (("call_ms", kernel), ("chain_ms", chain),
                         ("chain_uploads_ms", chain_uploads),
                         ("chain_uploads_ms", chain_uploads),
                         ("chain_ms", chain), ("call_ms", kernel)):
            call[name].append(host_sync_ms(fn, torch))
        del pn_sy
        # the PN bytes of each distinct table row the rows read, once
        pn_rows = int(torch.unique(
            idx.long().clamp(0, table.shape[0] - 1)).numel())
        n_bytes = (n * (4096 + idx.element_size() + 4 * spec.info_len + 1
                        + (4096 if v2 else 0))
                   + 1024 * pn_rows + 2 * 1024 + spec.info_len)
        n_ops = 20 * n * 1024                   # ~20 fp32 ops per element
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / FP32_FLOP_PER_S * 1e3
        line = {"phase": "kernel_check", "name": "payload_decode", "rows": n,
                "shape": list(lead) + [FRAME_LEN],
                "spec": f"K={spec.K} " + ("standard" if v2 else "compat"),
                "want_llr": v2,
                "table": [list(table.shape), str(table.dtype),
                          str(idx.dtype)],
                "max_abs_err": err, "tol_used": tol_used,
                "f64_max_abs_err": f64_err, "info_crc_ok_exact": exact,
                "crc_ok_rows": n_pass, "pn_rows_read": pn_rows,
                "ms": statistics.mean(dev["ms"]), "ms_turns": dev["ms"],
                "payload_llr_ms": statistics.mean(dev["payload_llr_ms"]),
                "plain_ms": cuda_ms(plain, torch, flush=flush, busy=busy),
                "floor_ms": cuda_ms(lambda: one.add_(1.0), torch,
                                    flush=flush, busy=busy),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
                "launch_host_us": host_us(kernel, torch),
                **{k: statistics.mean(v) for k, v in call.items()},
                "host_turns_ms": call}
        emit(line)
        if v2:
            entry = {
                "name": "payload_decode", "route": "cuda",
                "source": "echoseal_torch/csrc/payload_decode.cu",
                "replaces": "echoseal_tpu/ops/pallas/llr_kernel.py:51",
                "launches": None, "max_abs_err": None,
                **{k: line[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "floor_ms")},
            }
    check(f64_max["kernel"] <= 2.0 * f64_max["plain"],
          f"payload_decode: largest float64 distance {f64_max}, the "
          "kernel's over twice the plain version's")
    return max_err, entry


def _scl_work(scl, spec, rows: int, L: int) -> dict:
    """One exact decode's work, counted from its node schedule: fp32
    operations (each exp and log1p counted as one), the exp and log1p among
    them, and the bytes in (the LLRs) and out (info bits, crc_ok,
    metrics).  Per element: f 10 fp32 + 4 transcendental, g 1, a softplus
    of a rate-0 node 5 + 2, a leaf penalty pair 5 + 2; a fork adds two
    candidates; the rank counts and partial sums are integer work."""
    ops = scl.node_schedule(spec)
    code, width = ops & 15, spec.N >> ((ops >> 4) & 15)
    half = width // 2
    elems = {c: int(np.sum(np.where(code == c, w, 0)))
             for c, w in ((scl.OP_F, half), (scl.OP_G, half),
                          (scl.OP_RATE0, width), (scl.OP_LEAF, 1),
                          (scl.OP_REP, width))}
    forks = scl.schedule_forks(ops, spec.N, L)
    transc = 4 * elems[scl.OP_F] + 2 * (elems[scl.OP_RATE0]
                                        + elems[scl.OP_LEAF]
                                        + elems[scl.OP_REP])
    fp32 = (10 * elems[scl.OP_F] + elems[scl.OP_G]
            + 5 * (elems[scl.OP_RATE0] + elems[scl.OP_LEAF]
                   + elems[scl.OP_REP]) + 2 * forks + transc)
    return {"fp32": rows * L * fp32, "transc": rows * L * transc,
            "bytes": rows * (4 * spec.N + L * (4 * spec.info_len + 5)),
            "forks": forks}


def _fork_round_ms(torch, scl, spec, L: int, busy: int,
                   k: int = 512, block_seg: int | None = None,
                   kernel=None) -> float:
    """One fork round of the kernel at list size L: a row decoded along a
    schedule of the f chain to one leaf and then k leaf forks, less the
    same schedule with no forks, over k; with ``block_seg``, in the serving
    kernel; ``kernel``, another build's ``scl.bind``."""
    n = spec.N.bit_length() - 1
    x = torch.zeros(1, spec.N, device="cuda")
    head = [scl._op(scl.OP_F, lv, 0) for lv in range(n)]
    t = {}
    for m in (0, k):
        ops = torch.tensor(head + [scl._op(scl.OP_LEAF, n, 0)] * m,
                           dtype=torch.int32, device="cuda")
        if block_seg is None:
            def run():
                scl.scl_decode_kernel(x, spec, L, ops=ops, kernel=kernel)
        else:
            def run():
                scl.scl_decode_serving_kernel(x, spec, L, block_seg, ops=ops,
                                              kernel=kernel)
        t[m] = cuda_ms(run, torch, n=10, busy=busy)
    return (t[k] - t[0]) / k


def _node_round_ms(torch, scl, spec, L: int, busy: int, block_seg: int,
                   k: int = 64, kernel=None) -> float:
    """One node fork of the serving kernel at list size L: a row decoded
    along the f chain to the level of ``serving_schedule(spec,
    block_seg)``'s widest node and then k rate-1 node ops there, less the
    same schedule with no node op, over the k min(L-1, w) forks (each
    node's rank pass and partial sums shared among its forks); 0 when a
    node makes no fork (L = 1)."""
    n = spec.N.bit_length() - 1
    span = scl._node_span(scl.serving_schedule(spec, block_seg), spec.N)
    lv = n - (span.bit_length() - 1)
    q = min(L - 1, span)
    if q == 0:
        return 0.0
    x = torch.zeros(1, spec.N, device="cuda")
    head = [scl._op(scl.OP_F, v, 0) for v in range(lv)]
    t = {}
    for m in (0, k):
        ops = torch.tensor(head + [scl._op(scl.OP_RATE1, lv, 0)] * m,
                           dtype=torch.int32, device="cuda")

        def run():
            scl.scl_decode_serving_kernel(x, spec, L, block_seg, ops=ops,
                                          kernel=kernel)
        t[m] = cuda_ms(run, torch, n=10, busy=busy)
    return (t[k] - t[0]) / (k * q)


def scl_kernel_phase(torch, flush, busy):
    """Phase 3c: the SCL kernel against its plain version (the eager walk)
    at every path's shape (``SCL_SHAPES``).

    Rows of random payloads through AWGN at the shape's sigma, the last
    two replaced by a noiseless codeword and an all-zero row (every fork a
    tie).  The contract (``scl.list_agreement``): per row the same
    CRC-passing payloads and first passing path, sorted metrics within
    rtol = atol = SCL_TOL, lists path for path except beside a near-equal
    metric (``ties``, counted).  Device times in turns with the busy
    harness (the kernel, ``ms``; the walk, ``plain_ms``, a chain of ~10**4
    launches).  ``bound_ms``, the larger of the bytes over HBM, the fp32
    operations over the fp32 peak and the exp/log1p over the SFU rate
    (``_scl_work``); ``floor_ms``, the dependency chain: the schedule's
    forks times one fork round at this L (``_fork_round_ms``), which a
    row's group of threads cannot beat however the rows spread.  ``plan``,
    the launch's layout (``scl.kernel_plan``): threads and shared memory
    per row, rows per block, blocks, the SMs they occupy, device scratch
    per row.  Returns (the largest metric difference, the ladder's
    first-rung ``kernels`` entry).
    """
    from echoseal_torch.core.profiles import ROBUST, profile_spec
    from echoseal_torch.ops import polar, scl

    specs = {"compat": polar.polar_spec(), "v2": profile_spec(ROBUST)}
    rng = np.random.default_rng(SEED + 13)
    fork_ms, entry, worst = {}, None, 0.0
    for name, rows, L, sigma in SCL_SHAPES:
        spec = specs[name]
        _, llr_np = _coded_rows(spec, rows, sigma, rng)
        llr_np[-2] = np.clip(_coded_rows(spec, 1, 1e-3, rng)[1][0], -16, 16)
        llr_np[-1] = 0.0
        x = torch.from_numpy(llr_np).cuda()
        got = scl.scl_decode_kernel(x, spec, L)
        want = scl._scl_decode_plain(x, spec, L)
        torch.cuda.synchronize()
        agree = scl.list_agreement(got, want, SCL_TOL)
        check(agree["holds"] and bool(got["crc_ok"][-2, 0]),
              f"scl_decode {name} at {rows} rows, L = {L}: {agree}, "
              f"noiseless row passes {bool(got['crc_ok'][-2, 0])}")
        worst = max(worst, agree["max_metric_err"])
        del got, want
        if L not in fork_ms:
            fork_ms[L] = _fork_round_ms(torch, scl, spec, L, busy)

        def kernel():
            scl.scl_decode_kernel(x, spec, L)

        def plain():
            scl._scl_decode_plain(x, spec, L)

        turns = {"ms": [], "plain_ms": []}
        for key, fn, n in (("ms", kernel, 10), ("plain_ms", plain, 2),
                           ("plain_ms", plain, 2), ("ms", kernel, 10)):
            turns[key].append(cuda_ms(fn, torch, n=n, flush=flush,
                                      busy=busy))
        work = _scl_work(scl, spec, rows, L)
        t = {"bytes": work["bytes"] / HBM_BYTES_PER_S * 1e3,
             "fp32": work["fp32"] / FP32_FLOP_PER_S * 1e3,
             "sfu": work["transc"] / SFU_OPS_PER_S * 1e3}
        line = {"phase": "kernel_check", "name": "scl_decode", "spec": name,
                "rows": rows, "L": L, "sigma": sigma, **agree,
                "ms": statistics.mean(turns["ms"]),
                "plain_ms": statistics.mean(turns["plain_ms"]),
                "turns_ms": turns, "bound_ms": max(t.values()),
                "bound_by": "bytes" if t["bytes"] >= max(t["fp32"], t["sfu"])
                else "operations", "bound_parts_ms": t,
                "fp32_ops": work["fp32"], "transc_ops": work["transc"],
                "bytes": work["bytes"], "forks": work["forks"],
                "fork_round_us": 1e3 * fork_ms[L],
                "floor_ms": work["forks"] * fork_ms[L], "library_ms": None,
                "launch_host_us": host_us(kernel, torch),
                "plan": scl.kernel_plan(spec.N, L, rows)}
        line["decodes_per_s"] = rows / (line["ms"] / 1e3)
        emit(line)
        if (name, rows, L) == ("v2", 1024, 8):
            entry = {
                "name": "scl_decode", "route": "cuda",
                "source": "echoseal_torch/csrc/scl_decode.cu",
                "replaces": "echoseal_tpu/ops/scl.py:871 (_scl_decode_unrolled"
                            ", a jitted XLA program, not a Pallas kernel)",
                "launches": None, "max_abs_err": None,
                **{k: line[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "floor_ms")},
                "shape": {"spec": name, "rows": rows, "L": L}}
        del x
    return worst, entry


def _serving_work(scl, spec, rows: int, L: int, block_seg: int) -> dict:
    """One serving decode's work, counted from its node schedule: fp32
    operations and the bytes in (the LLRs) and out (info bits, crc_ok,
    metrics).  Per element: a min-sum f 3 (two |.| and a min; the sign is
    a select), g 1, a rate-0 node's relu and sum 2, a repetition node's
    |.| and two sums 3, a leaf's |.| 1; a fork adds two candidates, an SPC
    node's fork one more.  The ranks, selects and partial sums are integer
    work, and there is no exp or log1p (the SFUs are idle).  ``forks``
    splits into ``leaf_forks`` (leaves and repetition nodes) and
    ``node_forks`` (rate-1 and SPC nodes)."""
    ops = scl.serving_schedule(spec, block_seg)
    code, width = ops & 15, spec.N >> ((ops >> 4) & 15)
    elems = {c: int(np.sum(np.where(code == c, w, 0)))
             for c, w in ((scl.OP_F, width // 2), (scl.OP_G, width // 2),
                          (scl.OP_RATE0, width), (scl.OP_LEAF, 1),
                          (scl.OP_REP, width))}
    forks = scl.schedule_forks(ops, spec.N, L)
    spc = int(np.minimum(L - 1, width[code == scl.OP_SPC] - 1).sum())
    fp32 = (3 * elems[scl.OP_F] + elems[scl.OP_G] + 2 * elems[scl.OP_RATE0]
            + elems[scl.OP_LEAF] + 3 * elems[scl.OP_REP] + 2 * forks + spc)
    leaf = int(np.isin(code, (scl.OP_LEAF, scl.OP_REP)).sum())
    return {"fp32": rows * L * fp32,
            "bytes": rows * (4 * spec.N + L * (4 * spec.info_len + 5)),
            "forks": forks, "leaf_forks": leaf, "node_forks": forks - leaf,
            "ops": int(ops.size)}


def serving_kernel_phase(torch, flush, busy):
    """Phase 3d: the serving kernel against its plain version, the eager
    serving walk ``scl._walk_decode(serving=True)``, at every serving
    path's shape (``SERVING_SHAPES``), on phase 3c's kind of rows (AWGN at
    ``SERVING_SIGMA``, then a noiseless codeword and an all-zero row).

    The contract is phase 3c's (``scl.list_agreement``).  Device times in
    turns with the busy harness: the serving kernel (``ms``), the walk
    (``plain_ms``) and the exact kernel at the same shape (``exact_ms``).
    ``bound_ms``, the larger of the bytes over HBM and the fp32 operations
    over the fp32 peak (``_serving_work``); ``floor_ms``, the schedule's
    leaf forks times one leaf-fork round of the serving kernel at this L
    (``_fork_round_ms``, ``fork_round_us``) plus its node forks times one
    node fork (``_node_round_ms``, ``node_round_us``).  Returns (the
    largest metric difference, the ladder's first-rung ``kernels``
    entry).
    """
    from echoseal_torch.core.profiles import ROBUST, profile_spec
    from echoseal_torch.ops import polar, scl

    specs = {"compat": polar.polar_spec(), "v2": profile_spec(ROBUST)}
    rng = np.random.default_rng(SEED + 14)
    fork_ms, node_ms, entry, worst = {}, {}, None, 0.0
    for name, rows, L, block_seg in SERVING_SHAPES:
        spec = specs[name]
        _, llr_np = _coded_rows(spec, rows, SERVING_SIGMA, rng)
        llr_np[-2] = np.clip(_coded_rows(spec, 1, 1e-3, rng)[1][0], -16, 16)
        llr_np[-1] = 0.0
        x = torch.from_numpy(llr_np).cuda()
        got = scl.scl_decode_serving_kernel(x, spec, L, block_seg)
        want = scl._walk_decode(x, spec, L, serving=True, block_seg=block_seg)
        torch.cuda.synchronize()
        agree = scl.list_agreement(got, want, SCL_TOL)
        check(agree["holds"] and bool(got["crc_ok"][-2, 0]),
              f"scl_serving {name} at {rows} rows, L = {L}, block_seg "
              f"{block_seg}: {agree}, noiseless row passes "
              f"{bool(got['crc_ok'][-2, 0])}")
        worst = max(worst, agree["max_metric_err"])
        del got, want
        if L not in fork_ms:
            fork_ms[L] = _fork_round_ms(torch, scl, spec, L, busy,
                                        block_seg=block_seg)
        if (name, L, block_seg) not in node_ms:
            node_ms[name, L, block_seg] = _node_round_ms(
                torch, scl, spec, L, busy, block_seg)

        def kernel():
            scl.scl_decode_serving_kernel(x, spec, L, block_seg)

        def plain():
            scl._walk_decode(x, spec, L, serving=True, block_seg=block_seg)

        def exact():
            scl.scl_decode_kernel(x, spec, L)

        turns = {"ms": [], "plain_ms": [], "exact_ms": []}
        for key, fn, n in (("ms", kernel, 10), ("plain_ms", plain, 2),
                           ("exact_ms", exact, 10), ("exact_ms", exact, 10),
                           ("plain_ms", plain, 2), ("ms", kernel, 10)):
            turns[key].append(cuda_ms(fn, torch, n=n, flush=flush,
                                      busy=busy))
        work = _serving_work(scl, spec, rows, L, block_seg)
        t = {"bytes": work["bytes"] / HBM_BYTES_PER_S * 1e3,
             "fp32": work["fp32"] / FP32_FLOP_PER_S * 1e3}
        line = {"phase": "kernel_check", "name": "scl_serving", "spec": name,
                "rows": rows, "L": L, "block_seg": block_seg,
                "sigma": SERVING_SIGMA, **agree,
                "ms": statistics.mean(turns["ms"]),
                "plain_ms": statistics.mean(turns["plain_ms"]),
                "exact_ms": statistics.mean(turns["exact_ms"]),
                "turns_ms": turns, "bound_ms": max(t.values()),
                "bound_by": "bytes" if t["bytes"] >= t["fp32"]
                else "operations", "bound_parts_ms": t,
                "fp32_ops": work["fp32"], "bytes": work["bytes"],
                "ops": work["ops"], "forks": work["forks"],
                "leaf_forks": work["leaf_forks"],
                "node_forks": work["node_forks"],
                "fork_round_us": 1e3 * fork_ms[L],
                "node_round_us": 1e3 * node_ms[name, L, block_seg],
                "floor_ms": work["leaf_forks"] * fork_ms[L]
                + work["node_forks"] * node_ms[name, L, block_seg],
                "library_ms": None,
                "launch_host_us": host_us(kernel, torch),
                "plan": scl.kernel_plan(spec.N, L, rows, block_seg, spec)}
        line["decodes_per_s"] = rows / (line["ms"] / 1e3)
        line["exact_over_serving"] = line["exact_ms"] / line["ms"]
        emit(line)
        if (name, rows, L, block_seg) == ("v2", 1024, 8, 16):
            entry = {
                "name": "scl_serving", "route": "cuda",
                "source": "echoseal_torch/csrc/scl_decode.cu",
                "replaces": "echoseal_tpu/ops/scl.py:871 (_scl_decode_unrolled"
                            "(serving=True), a jitted XLA program, not a "
                            "Pallas kernel)",
                "launches": None, "max_abs_err": None,
                **{k: line[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "floor_ms", "exact_ms")},
                "shape": {"spec": name, "rows": rows, "L": L,
                          "block_seg": block_seg}}
        del x
    return worst, entry


def compat_phases(torch, card):
    """Phases 4-6.

    Returns (kernel launches of the compat main path, the verifier, the
    (4096, 1215) host-made frames of the stream, the B clips' start
    samples in it).
    """
    from echoseal_torch.core.params import FRAME_LEN
    from echoseal_torch.models import pipeline as pl
    from echoseal_torch.models.embedder import frames_np
    from echoseal_torch.ops import build, demod

    # ---- 4. main path at full width ----------------------------------------
    bv = pl.BatchVerifier(KEY, max_ctr=MAX_CTR, peaks=PEAKS)
    check(bv.device.type == "cuda", f"verifier on {bv.device}")
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.backends.cudnn.allow_tf32 is False, "TF32 left on")
    emit({"phase": "precision",
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    host_frames, starts, clips, nv = compat_clips(torch, bv, rng)
    tx_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    verdicts = bv.verify_batch(clips, nv)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    accept = float(verdicts.mean())
    if accept != 1.0:
        out = bv.run_device(clips, nv)
        rej = np.flatnonzero(~verdicts)
        crc = out["crc_ok"].cpu().numpy().reshape(B, -1)[rej]
        check(False, f"accept rate {accept}: rejected clips {rej.tolist()}, "
                     f"frame starts {(starts[rej] // FRAME_LEN).tolist()}, "
                     f"CRC-passing candidates {crc.sum(1).tolist()}")
    check(decode_launches(launches) > 0,
          "payload_decode never launched on the compat path")
    check(launches.get("sync_xcorr", 0) == 0,
          f"the fp32 compat sync launched sync_xcorr: {launches}")
    SYNC_BY_PATH["compat"] = 0

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    noise = 0.05 * torch.randn(64, TPAD, device="cuda", generator=gen)
    noise_acc = bv.verify_batch(noise, torch.full_like(nv[:1], T).expand(64))
    check(not noise_acc.any(), f"{int(noise_acc.sum())} noise clips accepted")
    bad = pl.BatchVerifier(BAD_KEY, max_ctr=MAX_CTR, peaks=PEAKS)
    bad_acc = bad.verify_batch(clips, nv)
    check(not bad_acc.any(), f"{int(bad_acc.sum())} wrong-key clips accepted")
    del bad
    far = np.zeros((1, TPAD), np.float32)
    far[0, :T] = frames_np(bv.sec, bv._hop,
                           np.arange(70_000, 70_000 + -(-T // FRAME_LEN)),
                           bytes(8), rng=rng).reshape(-1)[:T] * COMPAT_SCALE
    table_only = bv.finish_host(bv.run_device(far, nv[:1]))
    details = {}
    rescued = bv.verify_batch(far, nv[:1], details=details)
    check(not table_only.any(), "counter-70000 clip accepted by the table pass")
    check(rescued.all() and details[0].stage == "ext_ctr",
          f"counter-70000 clip not rescued: {details}")
    emit({"phase": "main_path", "B": B, "T": T, "Tpad": TPAD,
          "max_ctr": MAX_CTR, "peaks": PEAKS, "accept": accept,
          "launches": launches, "first_call_s": first_s, "host_tx_s": tx_s,
          "peak_mem_gb": peak_gb, "noise_accepted": int(noise_acc.sum()),
          "wrong_key_accepted": int(bad_acc.sum()),
          "ctr70000": {"table_pass": bool(table_only[0]),
                       "verify": bool(rescued[0]),
                       "frame_ctr": details[0].frame_ctr}})

    # ---- 5. timing -----------------------------------------------------------
    bv.finish_host(bv.run_device(clips, nv))            # warm-up
    best, runs = None, []
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        marks = []
        t0 = time.perf_counter()
        start.record()
        out = bv.run_device(clips, nv, marks=marks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        v = bv.finish_host(out)
        t2 = time.perf_counter()
        check(v.all(), "timed run rejected clips")
        runs.append(t2 - t0)
        if best is None or t2 - t0 < best["total_s"]:
            best = {"total_s": t2 - t0, "device_s": t1 - t0,
                    "host_finish_s": t2 - t1,
                    "stage_ms": stage_ms(start, marks)}
    # demod + refine is 24 fp32 products of (4, rows/4, 1215) x (4, 1215,
    # 1215): 1 demod, 2 per refine iteration (4), 1 flip set-up, 12 flip
    # steps, 2 final
    rows = B * 4 * PEAKS * len(demod.SYNC_OFFSETS)
    gemm_tflop = 24 * 2 * rows * FRAME_LEN * FRAME_LEN / 1e12
    emit({"phase": "timing", "card": card, "B": B, "clip_s": CLIP_S,
          "rtf": B * CLIP_S / best["total_s"], "runs_total_s": runs, **best,
          "demod_refine_gemm_tflop": gemm_tflop,
          "demod_refine_tflops": gemm_tflop
          / (best["stage_ms"]["demod_refine"] / 1e3)})

    # ---- 6. the port on the card vs on the CPU -------------------------------
    cpu = pl.BatchVerifier(KEY, max_ctr=MAX_CTR, peaks=PEAKS, device="cpu")
    x4 = clips[:4].cpu()
    g = {k: v.cpu() for k, v in bv.run_device(x4.cuda(), nv[:4]).items()}
    c = cpu.run_device(x4, nv[:4].cpu())
    for k in ("peak_idx", "ctr", "hdr_lo16"):
        check(torch.equal(g[k], c[k]), f"{k}: card and CPU differ")
    redo = pl._decode_stage(g["chips"], g["peak_idx"], g["peak_val"],
                            cpu.tables)
    for k in ("crc_ok", "info_bits", "host_packed"):
        check(torch.equal(g[k], redo[k]),
              f"{k}: card decode differs from the CPU decode of its chips")
    v_g, v_c = bv.finish_host(g), cpu.finish_host(c)
    check(v_g.tolist() == v_c.tolist() == [True] * 4,
          f"verdicts card {v_g.tolist()} cpu {v_c.tolist()}")
    emit({"phase": "gpu_vs_cpu", "clips": 4, "verdicts_equal": True,
          "crc_ok_equal": bool(torch.equal(g["crc_ok"], c["crc_ok"])),
          "host_packed_equal": bool(torch.equal(g["host_packed"],
                                                c["host_packed"])),
          "chips_max_abs_diff": float((g["chips"] - c["chips"]).abs().max()),
          "chips_sign_agree": float((g["chips"].sign() == c["chips"].sign())
                                    .float().mean())})
    return decode_launches(launches), bv, host_frames, starts


def tone_host(n: int) -> np.ndarray:
    """``n`` samples of the 700 Hz host at amplitude 0.15."""
    return (0.15 * np.sin(2 * np.pi * 700 * np.arange(n) / FS)
            ).astype(np.float32)


def compat_clips(torch, bv, rng):
    """Phase 4's clips: a STREAM_FRAMES-frame stream from the port's host
    TX under ``bv``'s key (every random byte from ``rng``), B clips of 3 s
    cut at frame-aligned random starts, 35 dB down, in rows of TPAD.
    Returns (the host frames, the starts, the clips, the valid lengths)."""
    from echoseal_torch.core.params import FRAME_LEN
    from echoseal_torch.models.embedder import frames_np
    from echoseal_torch.ops import demod

    host_frames = frames_np(bv.sec, bv._hop, np.arange(STREAM_FRAMES),
                            bytes(8), rng=rng)
    stream = torch.from_numpy(host_frames.reshape(-1))
    starts = rng.integers(0, STREAM_FRAMES - -(-T // FRAME_LEN), B) * FRAME_LEN
    clips = torch.zeros(B, TPAD, device="cuda")
    clips[:, :T] = demod.slice_windows(
        stream.cuda(), torch.from_numpy(starts).cuda(), T) * COMPAT_SCALE
    nv = torch.full((B,), T, dtype=torch.int32, device="cuda")
    return host_frames, starts, clips, nv


def compat_single_cuts():
    """Phase 16's data: a 16 s silence-host stream from the seeded
    ``BatchEmbedder`` and N_SINGLE distinct 3.5 s cut starts.  Returns
    (the generator, the stream, the starts)."""
    from echoseal_torch.models.embedder import BatchEmbedder

    rng = np.random.default_rng(SEED + 6)
    stream = BatchEmbedder(KEY).embed(np.zeros(16 * FS, np.float32),
                                      session_nonce=b"smokeses", rng=rng)
    return rng, stream, rng.choice(stream.size - T35, N_SINGLE, replace=False)


def v2_single_cuts():
    """Phase 17's data: a 20 s tone host through the seeded
    ``RobustEmbedder`` and N_SINGLE distinct 3.5 s cut starts.  Returns
    (the generator, the stream, the starts)."""
    from echoseal_torch.models.robust import RobustEmbedder

    rng = np.random.default_rng(SEED + 7)
    stream = RobustEmbedder(KEY, rng=rng).process(tone_host(20 * FS))
    return rng, stream, rng.choice(stream.size - T35, N_SINGLE, replace=False)


def v2_clips(torch, rng, host):
    """A seeded v2 TX stream of ``host`` and B random 3 s cuts of it."""
    from echoseal_torch.models.robust import RobustEmbedder
    from echoseal_torch.ops import demod

    stream = RobustEmbedder(KEY, rng=rng).process(host)
    starts = rng.integers(0, stream.size - T, B)
    clips = torch.zeros(B, TPAD_V2, device="cuda")
    clips[:, :T] = demod.slice_windows(
        torch.from_numpy(stream).cuda(), torch.from_numpy(starts).cuda(), T)
    return stream, starts, clips


def v2_phases(torch, card):
    """Phases 7-11.

    Returns (kernel launches of the v2 main path, the verifier, its CPU
    twin on the same tables, the phase-7 stream, phase 9's clips on the
    host).
    """
    from echoseal_torch.core.profiles import ROBUST
    from echoseal_torch.models import pipeline as pl
    from echoseal_torch.ops import build, polar, scl

    # ---- 7. v2 main path at full width -------------------------------------
    t0 = time.perf_counter()
    rv = pl.RobustBatchVerifier(KEY)
    ctor_s = time.perf_counter() - t0
    check(rv.device.type == "cuda" and rv.max_ctr == MAX_CTR
          and rv.peaks == V2_PEAKS and rv._list_size == 32
          and rv._sync_dtype == torch.bfloat16
          and rv.tables["m_stack"].dtype == torch.float32,
          "RobustBatchVerifier defaults changed")
    scl_calls = []
    fallback = rv._scl_fallback

    def counted(out, mask, *args, **kw):
        scl_calls.append(int(mask.sum()))
        return fallback(out, mask, *args, **kw)

    rv._scl_fallback = counted

    rng = np.random.default_rng(SEED + 1)
    t0 = time.perf_counter()
    host = tone_host(STREAM_S_V2 * FS)
    stream, starts, clips = v2_clips(torch, rng, host)
    nv = torch.full((B,), T, dtype=torch.int32, device="cuda")
    tx_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    details = {}
    verdicts = rv.verify_batch(clips, nv, details=details)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    scl_launches("v2", launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    accept = float(verdicts.mean())
    check(accept == 1.0,
          f"v2 accept rate {accept}: rejected clips "
          f"{np.flatnonzero(~verdicts).tolist()} at samples "
          f"{starts[~verdicts].tolist()}")
    check(decode_launches(launches) > 0,
          "payload_decode never launched on the v2 path")
    check(launches.get("sync_xcorr", 0) == 1,
          f"the v2 call launched sync_xcorr {launches.get('sync_xcorr', 0)} "
          "times; need 1")
    SYNC_BY_PATH["v2"] = 1
    stages = {s: sum(d.stage == s for d in details.values())
              for s in ("hard", "scl", "ext_ctr")}

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    noise = 0.05 * torch.randn(64, TPAD_V2, device="cuda", generator=gen)
    n_calls = len(scl_calls)
    noise_acc = rv.verify_batch(
        noise, torch.full((64,), T, dtype=torch.int32, device="cuda"))
    check(not noise_acc.any(), f"{int(noise_acc.sum())} v2 noise clips accepted")
    check(len(scl_calls) == n_calls,
          f"pure noise reached the SCL fallback ({scl_calls[n_calls:]} clips)")
    bad = pl.RobustBatchVerifier(BAD_KEY)
    bad_acc = bad.verify_batch(clips, nv)
    check(not bad_acc.any(),
          f"{int(bad_acc.sum())} v2 wrong-key clips accepted")
    del bad
    emit({"phase": "v2_main_path", "B": B, "T": T, "Tpad": TPAD_V2,
          "max_ctr": rv.max_ctr, "peaks": rv.peaks,
          "list_size": rv._list_size, "sync_dtype": "bf16",
          "table_dtype": "f32", "accept": accept, "accept_stages": stages,
          "launches": launches, "verifier_init_s": ctor_s,
          "first_call_s": first_s, "host_tx_s": tx_s,
          "peak_mem_gb": peak_gb, "noise_accepted": int(noise_acc.sum()),
          "noise_scl_calls": len(scl_calls) - n_calls,
          "wrong_key_accepted": int(bad_acc.sum())})

    # ---- 8. v2 timing -------------------------------------------------------
    rv.verify_batch(clips, nv)                         # warm-up
    best, runs = None, []
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        marks = []
        rv.scl_rungs = []
        t0 = time.perf_counter()
        start.record()
        out = rv.run_device(clips, nv, marks=marks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        v = rv._finish_ladder(out, None, True, 1 << 20)
        t2 = time.perf_counter()
        check(v.all(), "v2 timed run rejected clips")
        runs.append(t2 - t0)
        if best is None or t2 - t0 < best["total_s"]:
            best = {"total_s": t2 - t0, "device_s": t1 - t0,
                    "ladder_host_s": t2 - t1,
                    "stage_ms": stage_ms(start, marks),
                    "scl_rungs": rv.scl_rungs}
        del out
    # LS demod: (4, B*K, 9720) @ (4, 9720, 2*1215) in fp32
    ls_tflop = 2 * 4 * B * V2_PEAKS * ROBUST.span * V2_NP * 1215 / 1e12
    emit({"phase": "v2_timing", "card": card, "B": B, "clip_s": CLIP_S,
          "rtf": B * CLIP_S / best["total_s"], "runs_total_s": runs, **best,
          "demod_gemm_tflop": ls_tflop,
          "demod_tflops": ls_tflop / (best["stage_ms"]["demod"] / 1e3),
          "peak_mem_gb": peak_gb})

    # ---- 9. the SCL ladder at full width -------------------------------------
    rng = np.random.default_rng(SEED + 2)
    _, _, sil = v2_clips(torch, rng, np.zeros(STREAM_S_V2 * FS, np.float32))
    rms = float(torch.sqrt(torch.mean(sil[:, :T] ** 2)))
    sil[:, :T] += rms * 10 ** (-4 / 20) * torch.randn(B, T, device="cuda",
                                                       generator=gen)
    t0 = time.perf_counter()
    hard = rv.verify_batch(sil, nv, use_scl=False)
    hard_s = time.perf_counter() - t0
    details = {}
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    full = rv.verify_batch(sil, nv, details=details)
    full_s = time.perf_counter() - t0
    n_scl_launches = scl_launches("scl_ladder", build.LAUNCHES)
    rungs = rv.scl_rungs
    n_scl = sum(d.stage == "scl" for d in details.values())
    check(n_scl >= 1, "no clip rescued by the SCL ladder")
    check(full.mean() >= hard.mean(),
          f"ladder accept {full.mean()} below hard accept {hard.mean()}")
    cpu = pl.RobustBatchVerifier.from_tables(
        KEY, {k: v.cpu().numpy() for k, v in rv.tables.items()},
        device="cpu")
    t0 = time.perf_counter()
    v_cpu = cpu.verify_batch(sil[:N_CPU_LADDER].cpu(), nv[:N_CPU_LADDER].cpu())
    cpu_s = time.perf_counter() - t0
    check(v_cpu.tolist() == full[:N_CPU_LADDER].tolist(),
          f"SCL-ladder verdicts card {full[:N_CPU_LADDER].tolist()} "
          f"cpu {v_cpu.tolist()}")
    emit({"phase": "scl_ladder", "B": B, "snr_db": 4.0,
          "hard_accept": float(hard.mean()), "ladder_accept": float(full.mean()),
          "rescued_by_scl": n_scl, "hard_s": hard_s, "ladder_call_s": full_s,
          "scl_launches": n_scl_launches,
          "rungs": [{"rows": r, "L": L, "n_rows": n, "s": s}
                    for r, L, n, s in rungs],
          "cpu_clips": N_CPU_LADDER, "cpu_verdicts_equal": True,
          "cpu_s": cpu_s})
    ladder_clips = sil.cpu()                   # phase 26 runs them again
    del sil

    # ---- 10. SCL-256 -----------------------------------------------------------
    spec = polar.polar_spec()
    rng = np.random.default_rng(SEED + 3)
    bits = np.stack([polar.encode_np(rng.bytes(55), spec)
                     for _ in range(N_SCL256)])
    y = (2.0 * bits - 1.0) + 0.3 * rng.standard_normal(bits.shape)
    llr = torch.from_numpy((2.0 * y / 0.09).astype(np.float32)).cuda()
    build.LAUNCHES.clear()
    res = scl.scl_decode(llr, spec, 256)               # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = scl.scl_decode(llr, spec, 256)
        res["crc_ok"].cpu()
        times.append(time.perf_counter() - t0)
    n_scl_launches = scl_launches("scl256", build.LAUNCHES)
    want = scl.scl_decode(llr[:N_CPU_SCL256].cpu(), spec, 256)

    def passing(r, i):
        ok = r["crc_ok"][i].cpu().numpy()
        return {polar.pack_info_bits(b)
                for b in r["info_bits"][i].cpu().numpy()[ok]}
    for i in range(N_CPU_SCL256):
        check(passing(res, i) == passing(want, i),
              f"SCL-256 row {i}: card and CPU CRC-passing sets differ")
    emit({"phase": "scl256", "card": card, "rows": N_SCL256, "L": 256,
          "sigma": 0.3, "decodes_per_s": N_SCL256 / min(times),
          "runs_s": times, "scl_launches": n_scl_launches,
          "crc_pass_rows": int(res["crc_ok"].any(-1).sum()),
          "cpu_rows_equal": N_CPU_SCL256})

    # ---- 11. v2 on the card vs on the CPU ------------------------------------
    x4 = clips[:4]
    g = {k: v.cpu() for k, v in rv.run_device(x4, nv[:4]).items()}
    c = cpu.run_device(x4.cpu(), nv[:4].cpu())
    for k in ("peak_idx", "hdr_lo16", "ctr"):
        check(torch.equal(g[k], c[k]), f"v2 {k}: card and CPU differ")
    redo = pl._decode_stage(g["chips"], g["peak_idx"], g["peak_val"],
                            cpu.tables, spec=cpu._spec, span=cpu.span,
                            soft_rows=4)
    for k in ("crc_ok", "scl_ctr", "blob", "blob_ctr"):
        check(torch.equal(g[k], redo[k]),
              f"v2 {k}: card decode differs from the CPU decode of its chips")
    check(torch.equal(g["host_packed"][:, :61], redo["host_packed"][:, :61]),
          "v2 host row: card differs from the CPU decode of its chips")
    q_g, q_c = (rv._parse_evidence(h.numpy())[1]
                for h in (g["host_packed"], redo["host_packed"]))
    check(np.allclose(q_g, q_c, rtol=1e-4, atol=1e-4),
          f"v2 evidence q: card {q_g} cpu {q_c}")
    v_g = rv._finish_ladder(g, None, True, 1 << 20)
    v_c = cpu._finish_ladder(c, None, True, 1 << 20)
    check(v_g.tolist() == v_c.tolist() == [True] * 4,
          f"v2 verdicts card {v_g.tolist()} cpu {v_c.tolist()}")
    rel = ((g["chips"] - c["chips"]).abs().amax(-1)
           / c["chips"].abs().amax(-1).clamp(min=1e-30))
    emit({"phase": "v2_gpu_vs_cpu", "clips": 4, "verdicts_equal": True,
          "crc_ok_equal": bool(torch.equal(g["crc_ok"], c["crc_ok"])),
          "host_packed_61_equal": bool(torch.equal(g["host_packed"][:, :61],
                                                   c["host_packed"][:, :61])),
          "scl_ctr_equal": bool(torch.equal(g["scl_ctr"], c["scl_ctr"])),
          "chips_max_abs_diff": float((g["chips"] - c["chips"]).abs().max()),
          "chips_max_row_rel_diff": float(rel.max())})
    del rv._scl_fallback                       # the counting wrapper
    return decode_launches(launches), rv, cpu, stream, ladder_clips


def tx_phase(torch, card, bv, host_frames):
    """Phase 12; returns the kernel launches of its verify."""
    from echoseal_torch.core.params import FRAME_LEN
    from echoseal_torch.models.embedder import (
        BatchEmbedder,
        synthesize_frames_device,
    )
    from echoseal_torch.ops import build, demod

    be = BatchEmbedder(KEY)
    check(be.device.type == "cuda", f"embedder on {be.device}")
    ctrs = np.arange(STREAM_FRAMES)
    frames = be.frames_device(ctrs, bytes(8), rng=np.random.default_rng(SEED))
    check(frames.is_cuda and frames.shape == (STREAM_FRAMES, FRAME_LEN)
          and frames.dtype == torch.float32, "frames_device output")
    err = float((frames.cpu() - torch.from_numpy(host_frames)).abs().max())
    check(err <= TX_TOL, f"device frames differ from frames_np by {err}")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        be.frames_device(ctrs, bytes(8), rng=np.random.default_rng(SEED))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    # the device part alone, on the inputs of a 4096-frame call
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def bits(*shape):
        return torch.randint(0, 2, shape, device="cuda", generator=gen,
                             dtype=torch.uint8)
    dev_args = (bits(STREAM_FRAMES, 440), bits(STREAM_FRAMES, 128),
                bits(STREAM_FRAMES, 1024), be._hdr_pn_sy, be._preamble_sy,
                torch.from_numpy(be._hop.indices(ctrs)).cuda(), be._t_fwd)
    dev_ms = cuda_ms(lambda: synthesize_frames_device(*dev_args), torch, n=10)

    n_frames = -(-T // FRAME_LEN)
    rng = np.random.default_rng(SEED + 4)
    starts = rng.integers(0, STREAM_FRAMES - n_frames, N_TX_CLIPS) * FRAME_LEN
    clips = torch.zeros(N_TX_CLIPS, TPAD, device="cuda")
    clips[:, :T] = demod.slice_windows(
        frames.reshape(-1), torch.from_numpy(starts).cuda(), T) \
        * 10.0 ** (-35.0 / 20.0)
    nv = torch.full((N_TX_CLIPS,), T, dtype=torch.int32, device="cuda")
    build.LAUNCHES.clear()
    verdicts = bv.verify_batch(clips, nv)
    launches = dict(build.LAUNCHES)
    check(verdicts.all(), f"device-made TX: rejected clips "
                          f"{np.flatnonzero(~verdicts).tolist()}")
    check(decode_launches(launches) > 0,
          "payload_decode never launched on the device-TX verify")
    chips_s = STREAM_FRAMES * FRAME_LEN / FS
    emit({"phase": "tx_device", "card": card, "frames": STREAM_FRAMES,
          "max_abs_err_vs_frames_np": err, "tol": TX_TOL,
          "frames_device_s": min(times), "runs_s": times,
          "frames_per_s": STREAM_FRAMES / min(times),
          "chips_rtf": chips_s / min(times),
          "device_part_ms": dev_ms,
          "verify_clips": N_TX_CLIPS, "verify_accept": float(verdicts.mean()),
          "launches": launches})
    return decode_launches(launches)


def _spy_retries(verifier):
    """Record {clip: lattice key} of each ``_retry_scaled`` call; returns
    (the list it fills, a function that removes the spy)."""
    calls = []
    orig = verifier._retry_scaled

    def spy(clips, n_valid, factors, *a, **k):
        q = verifier.RETRY_UP
        calls.append({int(i): int(round(q * f)) for i, f in factors.items()})
        return orig(clips, n_valid, factors, *a, **k)

    verifier._retry_scaled = spy

    def remove():
        del verifier._retry_scaled
    return calls, remove


def _recover_seconds(spans) -> dict:
    """Host seconds of one traced ``verify_batch_recover`` call, read from
    its spans: the first pass, the scan and the deferred escalation, and
    per retry round its own seconds and its SCL rungs' (``ladder.rung``)."""
    ids = {s["id"]: s for s in spans}

    def sec(s):
        return (s["end_ns"] - s["start_ns"]) / 1e9

    def round_of(s):
        while s["parent"] is not None:
            s = ids[s["parent"]]
            if s["name"] == "recover.round":
                return s["id"]
        return None

    scl = {}
    for s in spans:
        if s["name"] == "ladder.rung":
            r = round_of(s)
            scl[r] = scl.get(r, 0.0) + sec(s)
    rounds = [s for s in spans if s["name"] == "recover.round"]
    return {**{f"{n}_s": sum(sec(s) for s in spans
                             if s["name"] == f"recover.{n}")
               for n in ("first_pass", "scan", "deferred")},
            "rounds_s": [sec(s) for s in rounds],
            "rounds_scl_s": [scl.get(s["id"], 0.0) for s in rounds]}


def recover_phases(torch, card, rv, cpu, stream):
    """Phases 13-15; returns the kernel launches of the ingest path and of
    the recovery path, and for phase 26 the phase-14 batch on the host
    (clips, lengths) with phase 14's line."""
    from scipy.signal import resample_poly

    from echoseal_torch.ops import build
    from echoseal_torch.utils.channels import time_scale
    from echoseal_torch.utils.logging import tracing

    rng = np.random.default_rng(SEED + 5)
    starts = rng.integers(0, stream.size - T35, B)
    base = np.stack([stream[s:s + T35] for s in starts])      # (B, T35)

    # ---- 13. 44.1 kHz ingest at full width -----------------------------------
    t0 = time.perf_counter()
    t44 = T35 * 147 // 160
    y44 = resample_poly(base.astype(np.float64), 147, 160,
                        axis=-1).astype(np.float32)
    cap_np = np.zeros((B, TPAD_44K), np.float32)
    cap_np[:, :min(y44.shape[1], TPAD_44K)] = y44[:, :TPAD_44K]
    del y44
    cap = torch.from_numpy(cap_np).cuda()
    nv44 = np.full(B, t44, np.int32)
    prep_s = time.perf_counter() - t0

    y8, nv8 = rv._ingest(cap[:8], nv44[:8], 44_100)
    ref8 = resample_poly(cap_np[:8].astype(np.float64), 160, 147, axis=-1)
    n_out = ref8.shape[1]
    check(y8.shape[1] >= n_out == TPAD_REC, f"ingest width {tuple(y8.shape)}")
    rs_err = float(np.abs(y8[:, :n_out].cpu().numpy() - ref8).max()
                   / np.abs(ref8).max())
    check(rs_err <= RESAMPLE_TOL, f"device resampler vs scipy: {rs_err}")
    check(y8.shape[1] == n_out or float(y8[:, n_out:].abs().max()) == 0.0,
          "ingest tail past n_out is not zero")
    check(nv8.tolist() == [t44 * 160 // 147] * 8, f"ingest lengths {nv8}")
    del y8

    as_48k = rv.verify_batch(cap, nv44)
    check(not as_48k.any(),
          f"{int(as_48k.sum())} 44.1 kHz rows accepted when read as 48 kHz")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    details = {}
    verdicts = rv.verify_batch(cap, nv44, fs_in=44_100, details=details)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches_ingest = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    accept = float(verdicts.mean())
    check(accept == 1.0,
          f"44.1 kHz accept rate {accept}: rejected clips "
          f"{np.flatnonzero(~verdicts).tolist()}")
    check(decode_launches(launches_ingest) > 0,
          "payload_decode never launched on the ingest path")
    check(launches_ingest.get("resample", 0) == 1,
          f"resample launches of one ingest call: {launches_ingest}")
    RESAMPLE_BY_PATH["ingest_44k1"] = 1
    ingest_ms = cuda_ms(lambda: rv._ingest(cap, nv44, 44_100), torch, n=3)
    calls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = rv.verify_batch(cap, nv44, fs_in=44_100)
        calls.append(time.perf_counter() - t0)
        check(v.all(), "timed 44.1 kHz run rejected clips")
    fam = (160, 147, 147, TPAD_44K)
    check(fam in rv._resamplers, f"ingest resampler {list(rv._resamplers)}")
    k_taps = rv._resamplers[fam].k_taps
    emit({"phase": "ingest_44k1", "card": card, "B": B, "clip_s": 3.5,
          "t_in": TPAD_44K, "t_out": TPAD_REC, "accept": accept,
          "accept_stages": {s: sum(d.stage == s for d in details.values())
                            for s in ("hard", "scl", "ext_ctr")},
          "accepted_read_as_48k": int(as_48k.sum()),
          "resampler_rel_err_8_rows": rs_err, "tol": RESAMPLE_TOL,
          "k_taps": k_taps, "ingest_ms": ingest_ms,
          # the function's own floor: the input read once, the output
          # written once, at the card's memory rate
          "ingest_bound_ms": 4 * B * (TPAD_44K + TPAD_REC)
          / HBM_BYTES_PER_S * 1e3,
          "first_call_s": first_s, "call_s": min(calls), "runs_s": calls,
          "audio_s_per_s": B * t44 / 44_100 / min(calls),
          "launches": launches_ingest, "peak_mem_gb": peak_gb,
          "host_prep_s": prep_s})
    del cap, cap_np

    # ---- 14. time-scale recovery at full width --------------------------------
    t0 = time.perf_counter()
    scaled_np = np.zeros((B, TPAD_REC), np.float32)
    nvs = np.zeros(B, np.int32)
    for i in range(B):
        y = time_scale(base[i], SCALE)
        L = min(y.size, TPAD_REC)
        scaled_np[i, :L] = y[:L]
        nvs[i] = L
    scaled = torch.from_numpy(scaled_np).cuda()
    prep_s = time.perf_counter() - t0
    plain = rv.verify_batch(scaled, nvs)
    check(not plain.any(),
          f"{int(plain.sum())} time-scaled clips accepted without recovery")
    keys, unspy = _spy_retries(rv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    with tracing() as tr:
        rec = rv.verify_batch_recover(scaled, nvs)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    spans = tr.drain()
    secs = _recover_seconds(spans)
    launches_rec = dict(build.LAUNCHES)
    scl_launches("timescale_recover", launches_rec)
    n_chunks = -(-rv.recover_log["scan_rows"] // rv.SCAN_CHUNK)
    check(launches_rec.get("scale_scan", 0) == n_chunks,
          f"scale_scan launches {launches_rec} vs {n_chunks} scan chunks")
    SCAN_BY_PATH["timescale_recover"] = n_chunks
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log = rv.recover_log
    accept = float(rec.mean())
    rounds = [{k: len(v) if k == "dens" else v for k, v in r.items()
               if k not in ("clips", "keys")} for r in log["rounds"]]
    all_dens = sorted({d for r in log["rounds"] for d in r["dens"]})
    # again, with the scan bank and every resampler plan now cached
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tracing() as tr:
        rec2 = rv.verify_batch_recover(scaled, nvs)
    rec2_s = time.perf_counter() - t0
    check(rec2.tolist() == rec.tolist(), "second recovery call differs")
    secs2 = _recover_seconds(tr.drain())
    line = {"phase": "timescale_recover", "card": card, "B": B, "clip_s": 3.5,
            "factor": SCALE, "Tpad": TPAD_REC, "accept_plain": float(plain.mean()),
            "accept": accept, "gate": RECOVER_GATE, "seconds": rec_s,
            "audio_s_per_s": B * 3.5 / rec_s,
            "first_pass_s": secs["first_pass_s"], "scan_s": secs["scan_s"],
            "scan_rows": log["scan_rows"], "deferred_s": secs["deferred_s"],
            "rounds_run": len(rounds), "rounds": rounds,
            "distinct_dens": len(all_dens),
            "first_round_keys": sorted(set(keys[0].values())) if keys else [],
            "second_call": {
                "seconds": rec2_s, **{k: secs2[k] for k in (
                    "first_pass_s", "scan_s", "deferred_s", "rounds_s")},
                "scl_s": sum(secs2["rounds_scl_s"])},
            "launches": launches_rec, "peak_mem_gb": peak_gb,
            "rejected": np.flatnonzero(~rec).tolist(), "host_prep_s": prep_s}
    emit(line)
    check(accept >= RECOVER_GATE, f"recovery accept {accept} < {RECOVER_GATE}")
    # one launch per run_device (the first pass and each retry round), and
    # one per extended-counter pass that the ladders reach
    check(decode_launches(launches_rec) >= 1 + len(rounds),
          f"payload_decode launches {launches_rec} vs 1 + {len(rounds)} rounds")
    check(sum(r["host_rows"] for r in rounds) == 0,
          "a +-5 % factor left the device resampler family")
    # one resample launch a lattice group, each inside its span
    n_groups = sum(r["dens"] for r in rounds)       # dens counted above
    rs_spans = [sp for sp in spans if sp["name"] == "recover.resample"]
    check(launches_rec.get("resample", 0) == n_groups == len(rs_spans)
          and all(sp["attrs"].get("launches") == 1 for sp in rs_spans),
          f"resample launches {launches_rec} vs {n_groups} lattice groups")
    RESAMPLE_BY_PATH["timescale_recover"] = n_groups

    mix_f = np.asarray(MIXED_FACTORS)[rng.integers(0, len(MIXED_FACTORS),
                                                   N_MIXED)]
    mixed = np.zeros((N_MIXED, TPAD_REC), np.float32)
    nvm = np.zeros(N_MIXED, np.int32)
    for i, f in enumerate(mix_f):
        y = base[i] if f == 1.0 else time_scale(base[i], float(f))
        L = min(y.size, TPAD_REC)
        mixed[i, :L] = y[:L]
        nvm[i] = L
    is_one = mix_f == 1.0
    keys.clear()
    mixed_dev = torch.from_numpy(mixed).cuda()
    v_plain = rv.verify_batch(mixed_dev, nvm)
    t0 = time.perf_counter()
    v_mix = rv.verify_batch_recover(mixed_dev, nvm)
    mix_s = time.perf_counter() - t0
    retried = {i for r in keys for i, k in r.items() if k != rv.RETRY_UP}
    per_factor = {str(f): [int(v_mix[mix_f == f].sum()), int((mix_f == f).sum())]
                  for f in MIXED_FACTORS}
    emit({"phase": "timescale_mixed", "clips": N_MIXED,
          "factors": list(MIXED_FACTORS), "accept": float(v_mix.mean()),
          "gate": MIXED_GATE, "accepted_of_per_factor": per_factor,
          "unscaled_retried": sorted(int(i) for i in retried
                                     if is_one[i]),
          "seconds": mix_s, "rounds_run": len(rv.recover_log["rounds"])})
    check(v_mix.mean() >= MIXED_GATE, f"mixed recovery {v_mix.mean()}")
    check(is_one.any() and v_mix[is_one].all() and v_plain[is_one].all(),
          "an unscaled clip of the mixed batch was rejected")
    check(not v_plain[~is_one].any(), "a scaled clip verified unrecovered")
    del mixed_dev

    # ---- 15. recovery on the card vs on the CPU --------------------------------
    keys.clear()
    v_g = rv.verify_batch_recover(scaled[:4], nvs[:4])
    keys_g = list(keys)
    unspy()
    keys_c, unspy_c = _spy_retries(cpu)
    t0 = time.perf_counter()
    v_c = cpu.verify_batch_recover(scaled_np[:4], nvs[:4])
    cpu_s = time.perf_counter() - t0
    unspy_c()
    check(v_g.tolist() == v_c.tolist(),
          f"recovery verdicts card {v_g.tolist()} cpu {v_c.tolist()}")
    check(keys_g == keys_c, f"tried keys card {keys_g} cpu {keys_c}")
    emit({"phase": "recover_gpu_vs_cpu", "clips": 4,
          "verdicts": v_g.tolist(), "verdicts_equal": True,
          "equal_to_full_batch": v_g.tolist() == rec[:4].tolist(),
          "tried_keys": keys_g, "tried_keys_equal": True, "cpu_s": cpu_s})
    return (decode_launches(launches_ingest), decode_launches(launches_rec),
            (scaled_np, nvs, line))


def _pcts(seconds) -> dict[str, float]:
    ms = 1e3 * np.asarray(seconds)
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": float(ms.mean())}


def _timer_totals(Timer) -> dict[str, dict]:
    """The host-clock registry as {span: {n, total seconds}}."""
    return {k: {"n": v["n"], "total_s": v["total"]}
            for k, v in Timer.report().items()}


def _timed(fn, torch):
    """(result, host seconds) of ``fn()``, the device drained after it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def compat_single_phase(torch, card):
    """Phase 16; returns (kernel launches of the 30 verifies, the stream,
    the rejected clips' seconds)."""
    from echoseal_torch.models.detector import WatermarkDetector
    from echoseal_torch.models.embedder import WatermarkEmbedder
    from echoseal_torch.ops import build
    from echoseal_torch.utils.logging import Timer

    rng, stream, starts = compat_single_cuts()
    det = WatermarkDetector(KEY)
    check(det.device.type == "cuda" and det._list_size == 256,
          "WatermarkDetector defaults changed")
    r, first_s = _timed(lambda: det.verify_detailed(stream[:T35], FS), torch)
    check(r.authentic, "first compat single-clip verify rejected")

    Timer.registry.clear()
    build.LAUNCHES.clear()
    seconds, stages, tries = [], {}, []
    for s0 in starts:
        det = WatermarkDetector(KEY)            # fresh, outside the timer
        r, dt = _timed(lambda: det.verify_detailed(stream[s0:s0 + T35], FS),
                       torch)
        check(r.authentic and r.session_nonce == b"smokeses",
              f"compat cut at {s0} rejected: {r}")
        check(abs(r.frame_ctr * 1215 - (s0 + r.peak_pos)) <= 2,
              f"compat cut at {s0}: counter {r.frame_ctr} at {r.peak_pos}")
        seconds.append(dt)
        stages[r.stage] = stages.get(r.stage, 0) + 1
        tries.append(r.tries)
    launches = dict(build.LAUNCHES)
    scl_launches("compat_single", launches)
    split = _timer_totals(Timer)
    check(decode_launches(launches) >= N_SINGLE,
          f"payload_decode launches on the compat single-clip path: {launches}")

    cut = stream[starts[0]:starts[0] + T35]
    rejects = {}
    noise = (0.1 * rng.standard_normal(T35)).astype(np.float32)
    for name, key, clip in (("wrong_key", BAD_KEY, cut), ("noise", KEY, noise)):
        det = WatermarkDetector(key)
        Timer.registry.clear()
        build.LAUNCHES.clear()
        r, dt = _timed(lambda: det.verify_detailed(clip, FS), torch)
        check(not r.authentic, f"compat {name} clip accepted: {r}")
        rejects[name] = {"seconds": dt, "split": _timer_totals(Timer),
                         "scl_launches": scl_launches(
                             "compat_single_rejected", build.LAUNCHES)}
    frame = WatermarkEmbedder(KEY, rng=rng)._make_frame_chips()
    raw_ok, raw_s = _timed(
        lambda: WatermarkDetector(KEY).verify_raw_frame(frame), torch)
    raw_bad, raw_bad_s = _timed(
        lambda: WatermarkDetector(BAD_KEY).verify_raw_frame(frame), torch)
    check(raw_ok is True and raw_bad is False,
          f"verify_raw_frame: right key {raw_ok}, wrong key {raw_bad}")
    emit({"phase": "compat_single", "card": card, "clips": N_SINGLE,
          "clip_s": 3.5, "list_size": 256, "accept": 1.0, "stages": stages,
          "first_verify_s": first_s, **_pcts(seconds),
          "tries_max": int(max(tries)), "launches": launches,
          "host_split_30_clips": split, "rejects": rejects,
          "raw_frame": {"right_key": raw_ok, "seconds": raw_s,
                        "wrong_key": raw_bad, "wrong_key_seconds": raw_bad_s}})
    return (decode_launches(launches), stream,
            {k: v["seconds"] for k, v in rejects.items()})


def v2_single_phase(torch, card):
    """Phase 17; returns (kernel launches of the 30 verifies, the stream)."""
    from echoseal_torch.models import robust
    from echoseal_torch.ops import build
    from echoseal_torch.ops.resample import resample_to
    from echoseal_torch.utils.channels import time_scale
    from echoseal_torch.utils.logging import Timer

    rng, stream, starts = v2_single_cuts()
    rv, ctor_s = _timed(lambda: robust.RobustVerifier(KEY), torch)
    check(rv.device.type == "cuda" and rv._list_size == 32
          and rv.tables["m_stack"].shape == (4, 2, 1215, 9720),
          "RobustVerifier defaults changed")
    r, first_s = _timed(lambda: rv.verify_detailed(stream[:T35], FS), torch)
    check(r.authentic, "first v2 single-clip verify rejected")

    Timer.registry.clear()
    build.LAUNCHES.clear()
    seconds, stages = [], {}
    for s0 in starts:
        r, dt = _timed(lambda: rv.verify_detailed(stream[s0:s0 + T35], FS),
                       torch)
        check(r.authentic and r.timescale is None,
              f"v2 cut at {s0} rejected: {r}")
        seconds.append(dt)
        stages[r.stage] = stages.get(r.stage, 0) + 1
    launches = dict(build.LAUNCHES)
    scl_launches("v2_single", launches)
    split = _timer_totals(Timer)
    check(decode_launches(launches) >= N_SINGLE,
          f"payload_decode launches on the v2 single-clip path: {launches}")

    cut = stream[starts[0]:starts[0] + T35]
    r44, s44 = _timed(
        lambda: rv.verify_detailed(resample_to(44_100, cut, FS), 44_100), torch)
    check(r44.authentic, f"v2 44.1 kHz cut rejected: {r44}")
    Timer.registry.clear()
    rts, sts = _timed(lambda: rv.verify_detailed(time_scale(cut, SCALE), FS),
                      torch)
    check(rts.authentic and rts.timescale is not None
          and abs(rts.timescale - 0.97) <= 1e-3,
          f"v2 cut played {SCALE}x: {rts}")
    ts_split = _timer_totals(Timer)

    # noise through a fresh verifier, the scan bank designed anew
    robust.scaled_template_bank.cache_clear()
    rv_noise = robust.RobustVerifier(KEY)
    noise = (0.1 * rng.standard_normal(T35)).astype(np.float32)
    Timer.registry.clear()
    build.LAUNCHES.clear()
    rn, sn = _timed(lambda: rv_noise.verify_detailed(noise, FS), torch)
    check(not rn.authentic, f"v2 noise clip accepted: {rn}")
    noise_scl = scl_launches("v2_single_noise", build.LAUNCHES)
    emit({"phase": "v2_single", "card": card, "clips": N_SINGLE,
          "clip_s": 3.5, "list_size": 32, "accept": 1.0, "stages": stages,
          "verifier_init_s": ctor_s, "first_verify_s": first_s,
          **_pcts(seconds), "launches": launches,
          "host_split_30_clips": split,
          "capture_44k1": {"authentic": True, "stage": r44.stage,
                           "seconds": s44},
          "timescale": {"factor": SCALE, "authentic": True,
                        "recovered": rts.timescale, "stage": rts.stage,
                        "seconds": sts, "split": ts_split},
          "noise": {"authentic": False, "seconds": sn,
                    "split": _timer_totals(Timer),
                    "scl_launches": noise_scl}})
    return decode_launches(launches), stream


def _drive_monitor(mon, stream, tail, torch):
    """1 s feeds of ``stream`` then of ``tail``; (events, tail events, s)."""
    t0 = time.perf_counter()
    own = [ev for i in range(0, stream.size, FS)
           for ev in mon.feed(stream[i:i + FS])]
    own_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    foreign = [ev for i in range(0, tail.size, FS)
               for ev in mon.feed(tail[i:i + FS])] + mon.flush()
    torch.cuda.synchronize()
    return own, foreign, own_s, time.perf_counter() - t0


def monitor_pool_phase(torch, card, v2_stream):
    """Phase 18; returns the kernel launches of the stream monitors, of the
    batch monitor and of the pool."""
    from echoseal_torch.models import robust
    from echoseal_torch.models.embedder import BatchEmbedder
    from echoseal_torch.models.monitor import BatchStreamMonitor, StreamMonitor
    from echoseal_torch.models.service import VerifierPool
    from echoseal_torch.ops import build, demod

    rng = np.random.default_rng(SEED + 8)
    # ---- StreamMonitor, both tiers, with a foreign-session tail -------------
    compat20 = BatchEmbedder(KEY).embed(
        np.zeros(20 * FS, np.float32), session_nonce=b"smokeses", rng=rng)
    tails = {
        "compat": BatchEmbedder(KEY).embed(
            np.zeros(6 * FS, np.float32), session_nonce=b"foreign!", rng=rng),
        "v2": robust.RobustEmbedder(KEY, rng=rng).process(
            np.zeros(6 * FS, np.float32))}
    build.LAUNCHES.clear()
    mon_lines = {}
    for profile, stream in (("compat", compat20), ("v2", v2_stream)):
        mon = StreamMonitor(KEY, profile=profile)
        own, foreign, own_s, tail_s = _drive_monitor(mon, stream,
                                                     tails[profile], torch)
        check(len(own) == 9 and all(ev.result.authentic for ev in own),
              f"{profile} StreamMonitor: "
              f"{[(ev.t_start, ev.result.authentic) for ev in own]}")
        late = [ev for ev in foreign if ev.t_start >= 20.0]
        check(len(late) >= 2 and not any(ev.result.authentic for ev in late),
              f"{profile} StreamMonitor foreign tail: "
              f"{[(ev.t_start, ev.result.authentic) for ev in foreign]}")
        check(mon.session_nonce is not None, f"{profile} monitor: no latch")
        mon_lines[profile] = {
            "windows": len(own), "authentic": len(own), "stream_s": 20,
            "seconds": own_s, "audio_s_per_s": 20 / own_s,
            "tail_windows": len(foreign), "tail_rejected": len(late),
            "tail_seconds": tail_s,
            "stages": sorted({ev.result.stage for ev in own})}
    launches_mon = dict(build.LAUNCHES)
    check(decode_launches(launches_mon) >= 18,
          f"payload_decode launches of the stream monitors: {launches_mon}")

    # ---- BatchStreamMonitor over 120 s in 1 s feeds -------------------------
    host = tone_host(120 * FS)
    t0 = time.perf_counter()
    long_stream = robust.RobustEmbedder(KEY, rng=rng).embed(
        host, session_nonce=b"batchmon")
    tx_s = time.perf_counter() - t0
    bmon, bmon_init_s = _timed(lambda: BatchStreamMonitor(KEY), torch)
    check(bmon._bv.device.type == "cuda" and bmon._tpad == 4 * FS + 16_384,
          "BatchStreamMonitor defaults changed")
    build.LAUNCHES.clear()
    events, feeds = [], []
    for i in range(0, long_stream.size, FS):
        ev, dt = _timed(lambda: bmon.feed(long_stream[i:i + FS]), torch)
        events += ev
        feeds.append(dt)
    events += bmon.flush()
    launches_bmon = dict(build.LAUNCHES)
    accept = float(np.mean([ev.result.authentic for ev in events]))
    check(len(events) == 59 and accept == 1.0,
          f"BatchStreamMonitor: {len(events)} windows, accept {accept}")
    check(all(ev.result.session_nonce == b"batchmon" for ev in events),
          "BatchStreamMonitor: an event names another session")
    check(decode_launches(launches_bmon) >= len(events),
          f"payload_decode launches of the batch monitor: {launches_bmon}")
    with_window = [f for f, i in zip(feeds, range(len(feeds))) if i >= 3
                   and i % 2 == 1]
    bmon_line = {"stream_s": 120, "windows": len(events), "accept": accept,
                 "stages": {s: sum(ev.result.stage == s for ev in events)
                            for s in ("hard", "scl", "ext_ctr")},
                 "init_s": bmon_init_s, "host_tx_s": tx_s,
                 "feed_total_s": sum(feeds),
                 "audio_s_per_s": 120 / sum(feeds),
                 "feed": _pcts(feeds), "feed_with_window": _pcts(with_window),
                 "launches": launches_bmon}
    del bmon, long_stream

    # ---- VerifierPool: 3 keys, room for 2 ------------------------------------
    keys = [bytes([k]) * 32 for k in (0x11, 0x22, 0x33)]
    nv = torch.full((N_POOL_CLIPS,), T, dtype=torch.int32, device="cuda")
    batches = []
    for key in keys:
        stream = robust.RobustEmbedder(key, rng=rng).process(
            tone_host(STREAM_S_V2 * FS))
        starts = rng.integers(0, stream.size - T, N_POOL_CLIPS)
        clips = torch.zeros(N_POOL_CLIPS, TPAD_V2, device="cuda")
        clips[:, :T] = demod.slice_windows(
            torch.from_numpy(stream).cuda(), torch.from_numpy(starts).cuda(), T)
        batches.append(clips)
    pool = VerifierPool(profile="v2", max_keys=2)
    build.LAUNCHES.clear()
    steps = []

    def step(name, k, b, want, cached):
        v, dt = _timed(lambda: pool.verify(keys[k], batches[b], nv), torch)
        check(bool(v.all()) if want else not v.any(),
              f"pool {name}: accept {float(v.mean())}, wanted {want}")
        check(pool.cached_keys == [keys[i] for i in cached],
              f"pool {name}: cached keys "
              f"{[keys.index(c) for c in pool.cached_keys]}, wanted {cached}")
        steps.append({"step": name, "seconds": dt, "accept": float(v.mean())})

    step("key0_build", 0, 0, True, [0])
    step("key1_build", 1, 1, True, [0, 1])
    step("key1_cached", 1, 1, True, [0, 1])
    step("key1_on_key0_clips", 1, 0, False, [0, 1])
    step("key2_build_evicts_key0", 2, 2, True, [1, 2])
    step("key0_rebuilt_evicts_key1", 0, 0, True, [2, 0])
    step("key2_on_key1_clips", 2, 1, False, [0, 2])
    launches_pool = dict(build.LAUNCHES)
    check(decode_launches(launches_pool) >= len(steps),
          f"payload_decode launches of the pool: {launches_pool}")
    emit({"phase": "monitors_pool", "card": card, "stream_monitor": mon_lines,
          "stream_monitor_launches": launches_mon,
          "batch_monitor": bmon_line,
          "pool": {"profile": "v2", "max_keys": 2, "keys": 3,
                   "clips_per_key": N_POOL_CLIPS, "steps": steps,
                   "launches": launches_pool}})
    return (decode_launches(launches_mon), decode_launches(launches_bmon),
            decode_launches(launches_pool))


def device_pair_phase(torch, card, compat_stream, v2_stream):
    """Phase 19: the single-clip tiers on the card and on the CPU."""
    from echoseal_torch.models.detector import WatermarkDetector
    from echoseal_torch.models.robust import RobustVerifier

    from echoseal_torch.core.params import FRAME_LEN

    rng = np.random.default_rng(SEED + 9)
    line = {"phase": "single_gpu_vs_cpu", "clips_per_tier": N_DEVICE_PAIR,
            "fields": list(RESULT_FIELDS)}
    frame_fields = ("frame_ctr", "band", "peak_pos")
    for tier, cls, stream in (("compat", WatermarkDetector, compat_stream),
                              ("v2", RobustVerifier, v2_stream)):
        gpu = cls(KEY)
        cpu = cls.from_tables(
            KEY, {k: v.cpu().numpy() for k, v in gpu.tables.items()},
            device="cpu")
        check(cpu.device.type == "cpu" and gpu.device.type == "cuda",
              "device pair not on two devices")
        rows, cpu_s = [], 0.0
        for s0 in rng.choice(stream.size - T35, N_DEVICE_PAIR, replace=False):
            clip = stream[s0:s0 + T35]
            gpu.session_nonce = cpu.session_nonce = None
            rg = gpu.verify_detailed(clip, FS)
            t0 = time.perf_counter()
            rc = cpu.verify_detailed(clip, FS)
            cpu_s += time.perf_counter() - t0
            differ = [f for f in RESULT_FIELDS
                      if getattr(rg, f) != getattr(rc, f)]
            ok = rg.authentic and rc.authentic
            if tier == "compat":
                # another frame of the clip may accept first; each side's
                # counter must then be the one its peak position implies
                ok = ok and set(differ) <= set(frame_fields) and all(
                    abs(r.frame_ctr * FRAME_LEN - (s0 + r.peak_pos)) <= 2
                    and r.band == gpu._hop.band(r.frame_ctr)
                    for r in (rg, rc))
            else:
                ok = ok and not differ
            check(ok, f"{tier} cut at {s0}: card {rg} cpu {rc}")
            rows.append({"start": int(s0), "stage": rg.stage,
                         "fields_equal": not differ,
                         "frame_ctr": [rg.frame_ctr, rc.frame_ctr],
                         "peak_pos": [rg.peak_pos, rc.peak_pos],
                         "tries": [rg.tries, rc.tries]})
        line[tier] = {"clips_all_fields_equal":
                      sum(r["fields_equal"] for r in rows),
                      "clips": rows, "cpu_s": cpu_s}
    emit(line)


# ======================================================================
# phases 20-23: impaired captures through the batch tier
# ======================================================================
def _impair(channels, kind: str, arg, x: np.ndarray, rng) -> np.ndarray:
    """One host impairment of ``benchmarks/impaired_bench.py`` or
    ``benchmarks/codec_envelope.py`` on one clip."""
    if kind == "sim":
        return channels.codec_sim(x, 128.0)[:x.size]
    if kind == "awgn":
        return channels.awgn(x, arg, rng)
    if kind == "timescale":
        return channels.time_scale(x, arg)
    if kind == "reverb":
        return channels.reverb(x, 150.0, direct_to_reverb_db=6.0, rng=rng)
    if kind == "l2":
        return channels.codec_mpeg1_l2(x, arg)[:x.size]
    if kind == "l3":
        return channels.codec_mpeg1_l3(x, arg)[:x.size]
    if kind == "ratecv":
        return channels.codec_ratecv(x, FS, arg)
    return getattr(channels, f"codec_{kind}")(x)      # ulaw, alaw, adpcm


def _shared(name: str, shape):
    """(segment, float32 array on it) of a shared-memory block."""
    shm = shared_memory.SharedMemory(name=name)
    return shm, np.ndarray(shape, np.float32, buffer=shm.buf)


def _stage_job(kind: str, arg, src, lo: int, hi: int, dst, seed: int):
    """Worker process: impair rows ``lo:hi`` of the shared base ``src``
    into the same rows of the shared output ``dst`` (each a (name, shape)
    pair), zero-padded.  Returns (lengths, seconds, wall-clock start,
    wall-clock end); no clip crosses the pipe."""
    from echoseal_torch.utils import channels

    w0, t0 = time.time(), time.perf_counter()
    s_shm, base = _shared(*src)
    d_shm, out = _shared(*dst)
    rng = np.random.default_rng(seed)
    lengths = []
    for i in range(lo, hi):
        y = _impair(channels, kind, arg, base[i].copy(), rng)
        L = min(y.size, out.shape[1])
        out[i, :L] = y[:L]
        lengths.append(L)
    del base, out
    s_shm.close()
    d_shm.close()
    return lengths, time.perf_counter() - t0, w0, time.time()


@contextlib.contextmanager
def _one_thread_workers():
    """One BLAS/OpenMP thread in each worker spawned inside the block.

    The workers load numpy with the environment they are spawned with;
    with the default (one thread per core) eight workers kept 64 BLAS
    threads spinning on eight cores, starving the host thread that
    feeds the card.
    """
    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" for k in keys})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


class Stager:
    """Host impairment staging over a process pool, one row at a time.

    Every row's jobs are submitted up front, in the order the rows are
    verified, so the workers stage later rows while the card verifies
    earlier ones.  Clips move through shared memory, not the pool's
    pipes: pickling them through the parent took its interpreter lock
    from the thread that feeds the card's eager SCL decoder.  ``take``
    returns a row's clips zero-padded to its width, their valid lengths,
    and the row's staging record: the workers' summed seconds, the
    seconds the caller waited, and when the row's first job started and
    its last ended, in seconds from the pool's creation.  ``close``
    frees every segment.
    """

    def __init__(self, pool) -> None:
        self.pool = pool
        self.t0 = time.time()
        self.rows: dict[str, tuple] = {}
        self.bases: list = []

    def share(self, arr: np.ndarray):
        """Copy ``arr`` into a shared segment; returns its (name, shape)."""
        shm = shared_memory.SharedMemory(create=True, size=arr.nbytes)
        np.ndarray(arr.shape, np.float32, buffer=shm.buf)[:] = arr
        self.bases.append(shm)
        return shm.name, arr.shape

    def submit(self, row: str, kind: str, arg, src, n: int, width: int,
               seed: int, chunk: int) -> None:
        out = shared_memory.SharedMemory(create=True, size=n * width * 4)
        dst = (out.name, (n, width))
        self.rows[row] = (out, dst[1], [
            self.pool.submit(_stage_job, kind, arg, src, i,
                             min(i + chunk, n), dst, seed + i)
            for i in range(0, n, chunk)])

    def take(self, row: str):
        out, shape, futures = self.rows.pop(row)
        t0 = time.perf_counter()
        parts = [f.result() for f in futures]
        wait_s = time.perf_counter() - t0
        clips = np.ndarray(shape, np.float32, buffer=out.buf).copy()
        out.close()
        out.unlink()
        nv = np.array([L for p in parts for L in p[0]], np.int32)
        stage = {"stage_cpu_s": sum(p[1] for p in parts),
                 "stage_wait_s": wait_s,
                 "stage_first_start_s": min(p[2] for p in parts) - self.t0,
                 "stage_last_end_s": max(p[3] for p in parts) - self.t0}
        return clips, nv, stage

    def close(self) -> None:
        for shm in self.bases + [r[0] for r in self.rows.values()]:
            shm.close()
            shm.unlink()
        self.bases, self.rows = [], {}


def _pad(base: np.ndarray, width: int):
    clips = np.zeros((base.shape[0], width), np.float32)
    clips[:, :base.shape[1]] = base
    return clips, np.full(base.shape[0], base.shape[1], np.int32)


def _verify_row(torch, verifier, clips: np.ndarray, nv: np.ndarray, *,
                recover: bool = False, fs_in: int | None = None,
                scl_path: str | None = None):
    """One row on the card: (verdicts, details, measured fields); its
    scl_decode launches are added to ``scl_path``."""
    from echoseal_torch.ops import build
    from echoseal_torch.utils.logging import tracing

    x = torch.from_numpy(clips).cuda()
    rungs = hasattr(verifier, "scl_rungs")
    if rungs:
        verifier.scl_rungs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    details = {}
    t0 = time.perf_counter()
    if recover:
        with tracing() as tr:
            v = verifier.verify_batch_recover(x, nv)
    elif fs_in is not None:
        v = verifier.verify_batch(x, nv, fs_in=fs_in, details=details)
    else:
        v = verifier.verify_batch(x, nv, details=details)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    audio_s = float(np.sum(nv)) / (fs_in or FS)
    line = {"n": int(v.size), "accept": float(v.mean()), "verify_s": s,
            "audio_s_per_s": audio_s / s,
            "launches": decode_launches(build.LAUNCHES),
            "scl_launches": (scl_launches(scl_path, build.LAUNCHES)
                             if scl_path else
                             build.LAUNCHES.get("scl_decode", 0)),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if recover:
        secs = _recover_seconds(tr.drain())
        line.update(scl_s=sum(secs["rounds_scl_s"]),
                    rounds_run=len(verifier.recover_log["rounds"]),
                    deferred_s=secs["deferred_s"])
    else:
        line["stages"] = {st: sum(d.stage == st for d in details.values())
                          for st in ("hard", "scl", "ext_ctr")}
        if rungs:
            line.update(scl_s=sum(r[3] for r in verifier.scl_rungs),
                        scl_rungs=[{"rows": r, "L": L, "n_rows": n, "s": t}
                                   for r, L, n, t in verifier.scl_rungs])
    del x
    return v, details, line


def _jax_rows() -> dict:
    """The JAX package's rows on the TPU, reported beside the port's."""
    root = Path(__file__).resolve().parent / "benchmarks"
    imp = json.loads((root / "impaired_1k.json").read_text())
    env = json.loads((root / "codec_envelope.json").read_text())
    return {"compat": imp["compat"],
            "v2_tone": imp["robust_v2(loud tone host)"],
            "v2_speech": imp["robust_v2(speech host)"],
            "codec": env["v2"]}


def _jax_accept(table: dict, row: str):
    for k, v in table.items():
        if k == row or (row.startswith("awgn(wm") and k.startswith("awgn(wm")):
            return v.get("accept")
    return None


def impaired_setup(host_frames, v2_stream, st):
    """Bases of phases 20-22 and every staging job, submitted in the
    order the rows are verified."""
    from echoseal_torch.core.params import FRAME_LEN, TxParams
    from echoseal_torch.models.robust import RobustEmbedder
    from echoseal_torch.utils import channels

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 10)
    # compat: frame-aligned 3.5 s cuts of the phase-4 stream at the floor
    n_frames = -(-T35 // FRAME_LEN)
    flat = host_frames.reshape(-1) * 10.0 ** (TxParams().floor_rel_dbfs / 20)
    starts = rng.integers(0, host_frames.shape[0] - n_frames, B) * FRAME_LEN
    compat = np.stack([flat[s:s + T35] for s in starts]).astype(np.float32)
    # v2 tone host: 3.5 s cuts of the phase-7 stream
    starts = rng.integers(0, v2_stream.size - T35, B)
    tone = np.stack([v2_stream[s:s + T35] for s in starts])
    host = tone_host(STREAM_S_V2 * FS)
    wm_pow = float(np.mean((v2_stream[:host.size] - host) ** 2))
    delta_db = 10.0 * np.log10(float(np.mean(host ** 2)) / wm_pow)
    # speech host, embedded block-wise as the live TX path does
    speech = channels.speech_host(12.0, FS, rng=np.random.default_rng(77))
    tx = RobustEmbedder(KEY, rng=np.random.default_rng(SEED + 11))
    sp_stream = np.concatenate([tx.process(speech[i:i + 1024])
                                for i in range(0, speech.size, 1024)])
    starts = rng.integers(0, sp_stream.size - T35, B)
    sp = np.stack([sp_stream[s:s + T35] for s in starts])
    # codec draws: 4 s cuts of a 6 s 700 Hz host, a new session per draw
    host6 = tone_host(CODEC_T + 2 * FS)
    draws = []
    for k in range(CODEC_DRAWS):
        tx = RobustEmbedder(KEY, rng=np.random.default_rng(SEED + 100 + k))
        tx._session_nonce = bytes([0x40 + k]) * 8
        wm = tx.process(host6)
        s = int(np.random.default_rng(k).integers(0, wm.size - CODEC_T))
        draws.append(wm[s:s + CODEC_T])
    draws = np.stack(draws)
    bases = {"compat": compat, "tone": tone, "speech": sp, "draws": draws,
             "setup_s": time.perf_counter() - t0, "delta_db": delta_db}

    src = {k: st.share(v) for k, v in (("compat", compat), ("tone", tone),
                                       ("speech", sp), ("draws", draws))}
    wm_row = f"awgn(wm+6dB={6 + delta_db:.0f}dB-clip)"
    jobs = [("compat", "mp3-128k(sim)", "sim", None, "compat", B, 64),
            ("compat", "awgn+6dB", "awgn", 6.0, "compat", B, 128),
            ("compat", "awgn-15dB", "awgn", -15.0, "compat", B, 128),
            ("compat", "timescale+3.1%", "timescale", SCALE, "compat", B, 128),
            ("compat", "reverb(6dB,150ms)", "reverb", None, "compat", N_SUB,
             4),
            ("v2_tone", "mp3-128k(sim)", "sim", None, "tone", B, 64),
            ("v2_tone", "awgn+6dB", "awgn", 6.0, "tone", B, 128),
            ("v2_tone", "awgn-15dB", "awgn", -15.0, "tone", B, 128),
            ("v2_tone", wm_row, "awgn", 6.0 + delta_db, "tone", B, 128),
            ("v2_tone", "reverb(6dB,150ms)", "reverb", None, "tone", N_SUB, 4),
            ("v2_speech", "mp3-128k(sim)", "sim", None, "speech", B, 64),
            ("v2_speech", "reverb(6dB,150ms)", "reverb", None, "speech",
             N_SUB, 4),
            ("v2_speech", "mp3-128k(l3-real)", "l3", 128, "speech", N_L3, 1),
            ("v2_speech", "timescale+3.1%", "timescale", SCALE, "speech",
             N_SUB, 32)]
    for name, kind, arg in CODECS:
        jobs.append(("codec", name, kind, arg, "draws", CODEC_DRAWS, 1))
    for i, (tier, row, kind, arg, base, n, chunk) in enumerate(jobs):
        width = CODEC_WIDTH[44_100 if kind == "ratecv" else FS] \
            if tier == "codec" else TPAD_REC
        st.submit(f"{tier}/{row}", kind, arg, src[base], n, width,
                  SEED + 1000 * i, chunk)
    return bases, wm_row


def _row_line(card, tier, row, line, stage=None, gate=None, jax=None):
    emit({"phase": "impaired_row", "card": card, "tier": tier, "row": row,
          **line, "gate": gate, "jax_accept_tpu": jax, **(stage or {}),
          "cpu_count": os.cpu_count()})


def clean_rows(torch, card, bv, rv, bases, jax_rows):
    """The rows of phases 20-21 that need no staging, run while the
    workers stage the others: compat clean, speech clean, speech under a
    wrong key.  Returns (compat launches, speech launches, 4 clean speech
    clips for phase 23)."""
    from echoseal_torch.models import pipeline as pl

    clips, nv = _pad(bases["compat"], TPAD_REC)
    v, _, line = _verify_row(torch, bv, clips, nv, scl_path="impaired_compat")
    _row_line(card, "compat", "clean", line, gate=1.0,
              jax=_jax_accept(jax_rows["compat"], "clean"))
    check(line["accept"] == 1.0, f"compat clean accept {line['accept']}")
    compat = line["launches"]
    table = jax_rows["v2_speech"]
    clips, nv = _pad(bases["speech"], TPAD_REC)
    v, _, line = _verify_row(torch, rv, clips, nv,
                             scl_path="impaired_v2_speech")
    _row_line(card, "v2_speech", "clean", line, gate=SPEECH_GATE,
              jax=_jax_accept(table, "clean"))
    check(line["accept"] >= SPEECH_GATE,
          f"speech clean accept {line['accept']} < {SPEECH_GATE}")
    speech = line["launches"]
    keep = (clips[:N_DEVICE_PAIR].copy(), nv[:N_DEVICE_PAIR])
    bad = pl.RobustBatchVerifier(BAD_KEY)
    v, _, line = _verify_row(torch, bad, clips, nv,
                             scl_path="impaired_v2_speech")
    del bad
    _row_line(card, "v2_speech", "wrong-key", line, gate=0.0,
              jax=_jax_accept(table, "wrong-key"))
    check(line["accept"] == 0.0, f"speech wrong key accept {line['accept']}")
    return compat, speech + line["launches"], keep


def impaired_compat_phase(torch, card, bv, st, jax_rows):
    """Phase 20a: the staged compat rows; returns their kernel launches."""
    launches = 0
    for row in ("mp3-128k(sim)", "awgn+6dB", "awgn-15dB", "timescale+3.1%",
                "reverb(6dB,150ms)"):
        clips, nv, stage = st.take(f"compat/{row}")
        v, _, line = _verify_row(torch, bv, clips, nv,
                                 scl_path="impaired_compat")
        _row_line(card, "compat", row, line, stage, gate=0.0,
                  jax=_jax_accept(jax_rows["compat"], row))
        check(line["accept"] == 0.0,
              f"compat {row}: accept {line['accept']}, wanted 0.0")
        launches += line["launches"]
    return launches


def impaired_tone_phase(torch, card, rv, st, wm_row, jax_rows):
    """Phase 20b: v2 tone-host rows; returns (launches, 4+4 clips kept for
    phase 23)."""
    launches, keep = 0, {}
    for row, gate in (("mp3-128k(sim)", IMPAIRED_GATE), ("awgn+6dB", 0.0),
                      ("awgn-15dB", 0.0), (wm_row, IMPAIRED_GATE),
                      ("reverb(6dB,150ms)", IMPAIRED_GATE)):
        clips, nv, stage = st.take(f"v2_tone/{row}")
        v, _, line = _verify_row(torch, rv, clips, nv,
                                 scl_path="impaired_v2_tone")
        _row_line(card, "v2_tone", row, line, stage, gate=gate,
                  jax=_jax_accept(jax_rows["v2_tone"], row))
        ok = line["accept"] >= gate if gate else line["accept"] == 0.0
        check(ok, f"v2 tone {row}: accept {line['accept']}, gate {gate}")
        launches += line["launches"]
        if row.startswith(("mp3", "reverb")):
            keep[row] = (clips[:N_DEVICE_PAIR].copy(), nv[:N_DEVICE_PAIR])
    check(launches > 0, "payload_decode never launched on the v2 tone rows")
    return launches, keep


def impaired_speech_phase(torch, card, rv, st, jax_rows):
    """Phase 21: the staged speech-host rows; returns their launches."""
    launches = 0
    table = jax_rows["v2_speech"]
    for row in ("mp3-128k(sim)", "reverb(6dB,150ms)", "mp3-128k(l3-real)",
                "timescale+3.1%"):
        clips, nv, stage = st.take(f"v2_speech/{row}")
        v, _, line = _verify_row(torch, rv, clips, nv,
                                 recover="timescale" in row,
                                 scl_path="impaired_v2_speech")
        jax = _jax_accept(table, row)
        line["below_jax_by_more_than_0.1"] = (
            jax is not None and line["accept"] < jax - 0.10)
        _row_line(card, "v2_speech", row, line, stage, jax=jax)
        launches += line["launches"]
    return launches


def codec_phase(torch, card, rv, st, jax_rows):
    """Phase 22: real codecs through ``RobustVerifier`` clip by clip and
    through ``RobustBatchVerifier`` as one batch; returns launches."""
    from echoseal_torch.models.robust import RobustVerifier
    from echoseal_torch.ops import build

    single = RobustVerifier(KEY)
    wrong = RobustVerifier(BAD_KEY)
    launches = 0
    batch = {48_000: [], 44_100: []}
    rows = {}
    for name, kind, _ in CODECS:
        fs_in = 44_100 if kind == "ratecv" else FS
        out, lengths, stage = st.take(f"codec/{name}")
        clips = [out[i, :L] for i, L in enumerate(lengths)]
        build.LAUNCHES.clear()
        acc, secs = [], []
        for y in clips:
            single.session_nonce = None
            t0 = time.perf_counter()
            acc.append(bool(single.verify(y, fs_in)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        wrong_acc = []
        t0 = time.perf_counter()
        for y in clips[:N_WRONG_DRAWS]:
            wrong.session_nonce = None
            wrong_acc.append(bool(wrong.verify(y, fs_in)))
        wrong_s = time.perf_counter() - t0
        n_launch = decode_launches(build.LAUNCHES)
        scl_launches("codec_rows", build.LAUNCHES)
        launches += n_launch
        batch[fs_in].append((name, out, lengths))
        rows[name] = {"fs_in": fs_in, "n": len(acc), "accepted": sum(acc),
                      "accept": sum(acc) / len(acc), "gate": len(acc) - 1,
                      "verify_p50_ms": 1e3 * float(np.median(secs)),
                      "verify_max_ms": 1e3 * max(secs),
                      "wrong_key_accepted": sum(wrong_acc),
                      "wrong_key_n": len(wrong_acc), "wrong_key_s": wrong_s,
                      "launches": n_launch, **stage,
                      "jax_accept_tpu": _jax_accept(jax_rows["codec"], name)}
        check(sum(acc) >= len(acc) - 1,
              f"codec {name}: {sum(acc)} of {len(acc)} accepted")
        check(not any(wrong_acc), f"codec {name}: a wrong key accepted")
    batch_lines = {}
    for fs_in, parts in batch.items():
        clips = np.concatenate([o for _, o, _ in parts])
        nv = np.concatenate([n for _, _, n in parts])
        v, _, line = _verify_row(torch, rv, clips, nv,
                                 fs_in=None if fs_in == FS else fs_in,
                                 scl_path="codec_rows")
        line["per_row_accept"] = {
            name: float(v[i * CODEC_DRAWS:(i + 1) * CODEC_DRAWS].mean())
            for i, (name, _, _) in enumerate(parts)}
        batch_lines[str(fs_in)] = line
        launches += line["launches"]
    emit({"phase": "codec_rows", "card": card, "draws": CODEC_DRAWS,
          "clip_s": CODEC_T / FS, "cpu_count": os.cpu_count(),
          "rows": rows, "batch": batch_lines})
    check(launches > 0, "payload_decode never launched on the codec rows")
    return launches


def _compare_reports(g, c, tol, path="report"):
    """Bools, integers and strings equal; floats within ``tol(path)``."""
    if isinstance(c, dict):
        check(isinstance(g, dict) and g.keys() == c.keys(), f"{path} keys")
        for k in c:
            _compare_reports(g[k], c[k], tol, f"{path}.{k}")
    elif isinstance(c, float):
        check(abs(g - c) <= tol(path), f"{path}: card {g} cpu {c}")
    else:
        check(type(g) is type(c) and g == c, f"{path}: card {g} cpu {c}")


@contextlib.contextmanager
def _pinned_secrets():
    """Zero bytes for ``secrets.token_bytes``: the stage comparison seals
    its payloads with random AEAD nonces, and the card and CPU runs must
    see the same stream."""
    import secrets

    orig = secrets.token_bytes
    secrets.token_bytes = lambda n=32: bytes(n)
    try:
        yield
    finally:
        secrets.token_bytes = orig


def _quiet(fn, *args, **kwargs):
    """(result, stdout) of ``fn``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def pair_phase(torch, card, rv, cpu, keep):
    """Phase 23a: impaired clips through the batch tier on the card and on
    the CPU; verdicts and accepting stages must be row-identical."""
    pairs = {}
    for name, (clips, nv) in keep.items():
        d_g, d_c = {}, {}
        v_g = rv.verify_batch(torch.from_numpy(clips).cuda(), nv, details=d_g)
        t0 = time.perf_counter()
        v_c = cpu.verify_batch(torch.from_numpy(clips), nv, details=d_c)
        cpu_s = time.perf_counter() - t0
        s_g = {i: d.stage for i, d in d_g.items()}
        s_c = {i: d.stage for i, d in d_c.items()}
        check(v_g.tolist() == v_c.tolist() and s_g == s_c,
              f"{name}: card {v_g.tolist()} {s_g}, cpu {v_c.tolist()} {s_c}")
        pairs[name] = {"verdicts": v_g.tolist(),
                       "stages": [s_g.get(i) for i in range(len(v_g))],
                       "equal": True, "cpu_s": cpu_s}
    emit({"phase": "impaired_gpu_vs_cpu", "card": card,
          "clips_per_class": N_DEVICE_PAIR, "pairs": pairs})


def diagnostics_phase(torch, card):
    """Phase 23b: the diagnostics on the card, ``stage_compare`` against
    its CPU run.  Returns their kernel launches."""
    from echoseal_torch.diagnostics import (
        frozen_check,
        pn_check,
        polar_roundtrip,
        stage_compare,
    )
    from echoseal_torch.ops import build

    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    audit, _ = _quiet(frozen_check.audit, verbose=True)
    check(audit is True, "frozen_check.audit() on the card failed")
    _, pn_out = _quiet(pn_check.main)
    check("FAIL" not in pn_out and pn_out.count("OK") >= 3,
          f"pn_check: {pn_out}")
    _, pr_out = _quiet(polar_roundtrip.main, trials=16, list_size=8)
    check(len(pr_out.splitlines()) == 9, f"polar_roundtrip: {pr_out}")
    reports = {}
    for argv in (["--profile", "v2", "--impair", "mp3"],
                 ["--profile", "compat"]):
        with _pinned_secrets():
            g, _ = _quiet(stage_compare.main, argv + ["--device", "cuda"])
            c, _ = _quiet(stage_compare.main, argv + ["--device", "cpu"])
        compat = argv[1] == "compat"
        _compare_reports(g, c, lambda p: 0.01 if compat and p.split(".")[1]
                         in ("demod", "header", "llr") else 1e-3)
        reports[argv[1]] = g
    # stage_compare times the LLR stage alone: the payload_llr kernel
    launches = build.LAUNCHES.get("payload_llr", 0)
    check(launches >= 2, f"stage_compare's LLR launches: {launches}")
    emit({"phase": "diagnostics", "card": card, "frozen_check": audit,
          "pn_check": pn_out.splitlines(),
          "polar_roundtrip": pr_out.splitlines(),
          "stage_compare": reports, "seconds": time.perf_counter() - t0,
          "launches": launches})
    return launches


def impaired_phases(torch, card, bv, host_frames, rv, cpu, v2_stream):
    """Phases 20-23; returns ({path: payload_decode launches},
    {"diagnostics": payload_llr launches}).

    The staging jobs are queued first; the diagnostics (23b), which need
    none, run while the workers start.
    """
    t0 = time.perf_counter()
    jax_rows = _jax_rows()
    pool = ProcessPoolExecutor(os.cpu_count(),
                               mp_context=multiprocessing.get_context("spawn"))
    st = Stager(pool)
    try:
        with _one_thread_workers():     # the workers spawn at submission
            bases, wm_row = impaired_setup(host_frames, v2_stream, st)
        emit({"phase": "impaired_setup", "host_setup_s": bases["setup_s"],
              "cpu_count": os.cpu_count(), "codec_draws": CODEC_DRAWS,
              "wm_row": wm_row, "delta_db": bases["delta_db"]})
        llr_by_path = {"diagnostics": diagnostics_phase(torch, card)}
        by_path = {}
        compat, speech, speech_keep = clean_rows(torch, card, bv, rv, bases,
                                                 jax_rows)
        by_path["impaired_compat"] = compat + impaired_compat_phase(
            torch, card, bv, st, jax_rows)
        by_path["impaired_v2_tone"], keep = impaired_tone_phase(
            torch, card, rv, st, wm_row, jax_rows)
        keep["speech clean"] = speech_keep
        by_path["impaired_v2_speech"] = speech + impaired_speech_phase(
            torch, card, rv, st, jax_rows)
        by_path["codec_rows"] = codec_phase(torch, card, rv, st, jax_rows)
    finally:                          # a failed phase leaves jobs queued
        pool.shutdown(wait=True, cancel_futures=True)
        st.close()
    for path in ("impaired_compat", "impaired_v2_speech"):
        check(by_path[path] > 0, f"payload_decode never launched on {path}")
    pair_phase(torch, card, rv, cpu, keep)
    emit({"phase": "impaired_total", "seconds": time.perf_counter() - t0})
    return by_path, llr_by_path


# ======================================================================
# phases 24-25: native TX, the GUI verify and data parallelism
# ======================================================================
def _gui_verify(path: str) -> tuple[str, float]:
    """``RxGUI()`` (device None: the card) verifies ``path`` through its
    worker thread, with tkinter stubbed as in the tests (the card's host has
    no display); returns (the verdict label, host seconds)."""
    from unittest import mock

    sys.path.insert(0, str(ROOT / "tests"))     # as pytest imports it
    from torch_port_util import fake_tkinter, run_gui_verify

    with mock.patch.dict(sys.modules, fake_tkinter()):
        from echoseal_torch.gui.rx_gui import RxGUI

        root = mock.MagicMock(name="root")
        gui = RxGUI(root=root)
        gui.key_var.set(KEY.hex())
        gui.file_var.set(path)
        t0 = time.perf_counter()
        label = run_gui_verify(gui, root)
        return label, time.perf_counter() - t0


def native_gui_phase(torch, card):
    """Phase 24; returns {path: kernel launches} for "native_tx" and
    "gui_rx"."""
    import tempfile

    from echoseal_torch import native
    from echoseal_torch.cli import rx_app
    from echoseal_torch.io import wavio
    from echoseal_torch.models.detector import WatermarkDetector
    from echoseal_torch.native.stream import NativeStreamEmbedder
    from echoseal_torch.ops import build

    t0 = time.perf_counter()
    check(native.available(), "the C mixer did not build on the card's host")
    build_s = time.perf_counter() - t0

    # the ring stocked before every block, as the feeder keeps it live
    host = np.zeros(NATIVE_S * FS, np.float32)
    blocks, block_s = [], []
    with NativeStreamEmbedder(KEY, rng=np.random.default_rng(SEED + 24)) as tx:
        for i in range(0, host.size, 1024):
            deadline = time.perf_counter() + 10.0
            while (tx._mixer.available_chips < tx.LOW_WATER
                   and time.perf_counter() < deadline):
                time.sleep(0.0005)
            check(tx._mixer.available_chips >= 1024,
                  "the feeder thread left the ring short")
            t1 = time.perf_counter()
            blocks.append(tx.process(host[i:i + 1024]))
            block_s.append(time.perf_counter() - t1)
        frames = tx.frame_ctr
    stream = np.concatenate(blocks)
    us = 1e6 * np.asarray(block_s)
    # the same blocks through a mixer alone: no feeder thread to share the
    # interpreter lock with
    alone = native.NativeMixer()
    n_alone = alone.push_chips(stream)          # as much as the ring holds
    alone_s = []
    for i in range(0, n_alone - 1023, 1024):
        t1 = time.perf_counter()
        alone.process(host[i:i + 1024])
        alone_s.append(time.perf_counter() - t1)
    alone_us = 1e6 * np.asarray(alone_s)

    build.LAUNCHES.clear()
    ok, verify_s = _timed(lambda: WatermarkDetector(KEY).verify(stream, FS),
                          torch)
    check(ok is True, "the native TX stream did not verify on the card")
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "host.wav"), os.path.join(d, "wm.wav")
        wavio.write(src, host[:4 * FS], FS)
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "echoseal_torch.cli.tx_app", "--key",
             KEY.hex(), "--infile", src, "--outfile", dst, "--native"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t1
        check(proc.returncode == 0 and "watermarked 4.0s" in proc.stderr
              and "Python mixer" not in proc.stderr,
              f"tx_app --native: rc {proc.returncode}, {proc.stderr[-2000:]}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = rx_app.main(["--key", KEY.hex(), "--audio", dst])
        check(rc == 0 and out.getvalue() == "authentic\n",
              f"rx_app on the tx_app --native WAV: rc {rc}, {out.getvalue()}")
        native_launches = decode_launches(build.LAUNCHES)

        build.LAUNCHES.clear()
        label, gui_s = _gui_verify(dst)
        gui_launches = decode_launches(build.LAUNCHES)
    check(label == "AUTHENTIC", f"RxGUI on the card: {label!r}")
    emit({"phase": "native_tx_gui", "card": card,
          "host": "the card machine's host CPU",
          "mixer_build_or_load_s": build_s, "stream_s": NATIVE_S,
          "frames": frames, "blocks": len(block_s),
          "process_p50_us": float(np.percentile(us, 50)),
          "process_p99_us": float(np.percentile(us, 99)),
          "process_max_us": float(us.max()),
          "process_alone_p50_us": float(np.percentile(alone_us, 50)),
          "process_alone_p99_us": float(np.percentile(alone_us, 99)),
          "stream_verify_s": verify_s, "tx_app_native_s": cli_s,
          "gui_verify_s": gui_s, "gui_label": label,
          "launches": {"native_tx": native_launches, "gui_rx": gui_launches}})
    return {"native_tx": native_launches, "gui_rx": gui_launches}


def _row_rel_err(torch, g, w) -> float:
    """Largest |g - w| of each clip over the clip's largest |w| (finite
    entries; the non-finite ones must be equal)."""
    fin = torch.isfinite(w)
    check(torch.equal(fin, torch.isfinite(g))
          and torch.equal(g[~fin], w[~fin]), "non-finite entries differ")
    n = w.shape[0]
    d = torch.where(fin, (g - w).abs(), 0.0).reshape(n, -1).amax(1)
    s = torch.where(fin, w.abs(), 0.0).reshape(n, -1).amax(1)
    return float((d / s.clamp(min=1e-30)).max())


def sharded_phase(torch, card, bv, host_frames, starts, rv, v2_stream):
    """Phase 25; returns {path: kernel launches} for "sharded_compat" and
    "sharded_v2"."""
    import torch.distributed as dist

    from echoseal_torch.ops import build, demod
    from echoseal_torch.parallel.dryrun import _free_port
    from echoseal_torch.parallel.mesh import (
        shard_verify,
        shard_verify_v2,
        streams_mesh,
    )

    scale = 10.0 ** (-35.0 / 20.0)
    clips = torch.zeros(B, TPAD, device="cuda")
    clips[:, :T] = demod.slice_windows(
        torch.from_numpy(host_frames.reshape(-1)).cuda(),
        torch.from_numpy(starts).cuda(), T) * scale
    v2_starts = np.random.default_rng(SEED + 25).integers(
        0, v2_stream.size - T, B)
    clips2 = torch.zeros(B, TPAD_V2, device="cuda")
    clips2[:, :T] = demod.slice_windows(
        torch.from_numpy(v2_stream).cuda(), torch.from_numpy(v2_starts).cuda(),
        T)
    nv = torch.full((B,), T, dtype=torch.int32, device="cuda")

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = streams_mesh()
        check(mesh.device == dev and (mesh.rank, mesh.world_size) == (0, 1),
              f"mesh {mesh}")
        line = {"phase": "sharded", "card": card, "backend": "nccl",
                "world_size": 1, "B": B, "clip_s": CLIP_S,
                "init_s": time.perf_counter() - t0}
        by_path = {}
        tiers = (("compat", bv, clips, shard_verify,
                  lambda out: bv.finish_host(out)),
                 ("v2", rv, clips2, shard_verify_v2,
                  lambda out: rv._finish_ladder(out, None, True, 1 << 20)))
        for tier, verifier, x, shard, finish in tiers:
            run = shard(verifier, mesh)
            torch.cuda.synchronize()
            build.LAUNCHES.clear()
            out = run(x, nv)
            torch.cuda.synchronize()
            by_path[f"sharded_{tier}"] = decode_launches(build.LAUNCHES)
            whole = verifier.run_device(x, nv)
            check(set(out) == set(whole) | {"n_crc_ok"},
                  f"{tier} sharded keys {sorted(out)}")
            rel = 0.0
            for k, w in whole.items():
                g = out[k]
                check(g.shape == w.shape and g.dtype == w.dtype,
                      f"{tier} {k}: {g.dtype}{tuple(g.shape)} sharded")
                if w.is_floating_point():
                    rel = max(rel, _row_rel_err(torch, g, w))
                else:
                    check(torch.equal(g, w), f"{tier} {k}: sharded differs "
                                             "from the unsharded run_device")
            check(rel <= 1e-5, f"{tier}: floats differ by {rel} of a row")
            n_crc = int(out["n_crc_ok"])
            check(n_crc == int(whole["crc_ok"].sum()),
                  f"{tier}: all-reduced n_crc_ok {n_crc}")
            v_s, v_u = finish(out), finish(whole)
            check(v_s.tolist() == v_u.tolist() and v_s.all(),
                  f"{tier} sharded accept {v_s.mean()}, unsharded "
                  f"{v_u.mean()}")
            del out, whole

            # wall time of stage + finish, unsharded and sharded in turns
            times = {"unsharded": [], "sharded": []}
            for mode in ("unsharded", "sharded") * 3:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                o = run(x, nv) if mode == "sharded" else \
                    verifier.run_device(x, nv)
                check(finish(o).all(), f"{tier} {mode} timed run rejected")
                times[mode].append(time.perf_counter() - t1)
                del o
            best = {m: min(t) for m, t in times.items()}
            line[tier] = {
                "accept": 1.0, "n_crc_ok": n_crc,
                "launches": by_path[f"sharded_{tier}"],
                "max_row_rel_float_diff": rel,
                "rtf_sharded": B * CLIP_S / best["sharded"],
                "rtf_unsharded": B * CLIP_S / best["unsharded"],
                "sharded_over_unsharded_s": best["sharded"]
                / best["unsharded"], "runs_s": times}
        del clips, clips2
        torch.cuda.empty_cache()

        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "echoseal_torch.parallel.dryrun", "1"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        marker = [ln for ln in proc.stdout.splitlines()
                  if ln.startswith("DRYRUN_OK")]
        check(proc.returncode == 0 and len(marker) == 1
              and marker[0].endswith("recovered=1"),
              f"dryrun 1 on nccl: rc {proc.returncode}, {proc.stdout[-1000:]}"
              f" {proc.stderr[-3000:]}")
        line["dryrun"] = {"marker": marker[0],
                          "seconds": time.perf_counter() - t1}
    finally:
        dist.destroy_process_group()
    emit(line)
    return by_path


@contextlib.contextmanager
def scl_env(**env):
    """Set ECHOSEAL_SCL_* switches (None unsets one) for one leg; the
    previous environment comes back on the way out, also on a failure."""
    def put(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(f"ECHOSEAL_SCL_{k}", None)
            else:
                os.environ[f"ECHOSEAL_SCL_{k}"] = v

    old = {k: os.environ.get(f"ECHOSEAL_SCL_{k}") for k in env}
    try:
        put(env)
        yield
    finally:
        put(old)


def _slack(p: float, n: int) -> float:
    """``benchmarks/scl_sweep.py``'s binomial slack on a rate ``p`` of n."""
    return 2.0 * float(np.sqrt(max(p * (1.0 - p), 0.25 / n) / n))


def _first_pass_fer(res, sent: np.ndarray) -> float:
    """Share of rows whose first CRC-passing path is not the sent payload."""
    ok = res["crc_ok"].cpu().numpy()
    info = res["info_bits"].cpu().numpy()
    first = info[np.arange(ok.shape[0]), ok.argmax(-1)]
    return 1.0 - float((ok.any(-1) & (first == sent).all(-1)).mean())


def _coded_rows(spec, n: int, sigma: float, rng):
    """(sent info bits, float32 LLRs) of n random payloads through AWGN."""
    from echoseal_torch.ops import polar

    pays = [rng.bytes(spec.info_len // 8) for _ in range(n)]
    bits = np.stack([polar.encode_np(p, spec) for p in pays])
    y = (2.0 * bits - 1.0) + sigma * rng.standard_normal(bits.shape)
    sent = np.unpackbits(np.frombuffer(b"".join(pays), np.uint8)).reshape(n, -1)
    return sent, (2.0 * y / (sigma * sigma)).astype(np.float32)


def _aten_ops(fn) -> int:
    """Aten ops that ``fn()`` dispatches (what an eager decode launches)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.n


def scl_serving_phase(torch, card, rv, cpu, ladder_clips, recover_batch,
                      compat_stream, v2_stream, compat_rejects):
    """Phase 26: the fast-SSCL serving decoder and its switches beside the
    exact decoder; returns {path: kernel launches} of the serving ladder,
    recovery and single-clip legs."""
    from echoseal_torch.core.profiles import ROBUST, profile_spec
    from echoseal_torch.models.detector import WatermarkDetector
    from echoseal_torch.models.pipeline import RobustBatchVerifier
    from echoseal_torch.models.robust import RobustVerifier
    from echoseal_torch.ops import build, polar, scl
    from echoseal_torch.utils.logging import Timer, tracing

    t_phase = time.perf_counter()
    line = {"phase": "scl_serving", "card": card}

    # ---- (a) the decoder alone -------------------------------------------
    def passing(r, i):
        ok = r["crc_ok"][i].cpu().numpy()
        return {polar.pack_info_bits(b)
                for b in r["info_bits"][i].cpu().numpy()[ok]}

    rng = np.random.default_rng(SEED + 26)
    specs = {"compat": polar.polar_spec(), "v2": profile_spec(ROBUST)}
    sets = []
    for name, spec in specs.items():
        sent, llr = _coded_rows(spec, N_SERVING_ROWS, SERVING_SIGMA, rng)
        sets += [(name, spec, L, SERVING_SIGMA, sent, llr) for L in (8, 32)]
    # phase 10's rows: the SCL-256 set
    sent, llr = _coded_rows(specs["compat"], N_SCL256, 0.3,
                            np.random.default_rng(SEED + 3))
    sets.append(("compat", specs["compat"], 256, 0.3, sent, llr))
    decoders = []
    for name, spec, L, sigma, sent, llr_np in sets:
        llr = torch.from_numpy(llr_np).cuda()
        best, res = {}, {}
        for mode in TURNS:
            with scl_env(IMPL="serving" if mode == "serving" else None), \
                    no_card_walk():
                build.LAUNCHES.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = scl.scl_decode(llr, spec, L)
                r["crc_ok"].cpu()
                dt = time.perf_counter() - t0
                if mode == "serving":
                    serving_launches("serving_decoder", build.LAUNCHES)
                check(sum(build.LAUNCHES.values()) == 1,
                      f"{mode} decode: {dict(build.LAUNCHES)}")
            best[mode] = min(best.get(mode, dt), dt)
            res[mode] = r
        n = llr.shape[0]
        fer = {m: _first_pass_fer(res[m], sent) for m in res}
        slack = _slack(fer["exact"], n)
        check(fer["serving"] <= fer["exact"] + slack,
              f"serving FER {fer['serving']} > exact {fer['exact']} + "
              f"{slack} ({name}, L = {L})")
        ops = {}
        for mode in ("exact", "serving"):
            with scl_env(IMPL="serving" if mode == "serving" else None):
                ops[mode] = _aten_ops(lambda: scl.scl_decode(
                    llr[:N_CPU_SERVING], spec, L))
        with scl_env(IMPL="serving"):
            want = scl.scl_decode(llr[:N_CPU_SERVING].cpu(), spec, L)
        for i in range(N_CPU_SERVING):
            check(passing(res["serving"], i) == passing(want, i),
                  f"serving {name} L = {L} row {i}: card and CPU "
                  "CRC-passing sets differ")
        decoders.append({
            "spec": name, "L": L, "rows": n, "sigma": sigma,
            "exact_decodes_per_s": n / best["exact"],
            "serving_decodes_per_s": n / best["serving"],
            "serving_over_exact": best["exact"] / best["serving"],
            "exact_ops": ops["exact"], "serving_ops": ops["serving"],
            "exact_us_per_op": 1e6 * best["exact"] / ops["exact"],
            "serving_us_per_op": 1e6 * best["serving"] / ops["serving"],
            "exact_fer": fer["exact"], "serving_fer": fer["serving"],
            "slack": slack, "cpu_rows_equal": N_CPU_SERVING})
        del llr, res, want
    line["decoder"] = decoders

    # ---- (b) the v2 ladder ------------------------------------------------
    clips = ladder_clips.cuda()
    nv = torch.full((B,), T, dtype=torch.int32, device="cuda")
    hard = rv.verify_batch(clips, nv, use_scl=False)
    runs = {"exact": [], "serving": []}
    launches_ladder = 0
    for mode in ("exact", "serving", "serving", "exact"):
        with scl_env(SERVING="1" if mode == "serving" else None, IMPL=None), \
                no_card_walk():
            build.LAUNCHES.clear()
            details = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = rv.verify_batch(clips, nv, details=details)
            dt = time.perf_counter() - t0
            if mode == "serving":
                launches_ladder += decode_launches(build.LAUNCHES)
                check(serving_launches("serving_ladder", build.LAUNCHES)
                      == len(rv.scl_rungs),
                      f"serving ladder: {dict(build.LAUNCHES)} for "
                      f"{len(rv.scl_rungs)} rungs")
            else:
                check(build.LAUNCHES.get("scl_serving", 0) == 0,
                      "the exact ladder launched the serving kernel")
                scl_launches("serving_phase_exact_ladder", build.LAUNCHES)
        runs[mode].append({
            "accept": float(v.mean()), "seconds": dt,
            "rescued_by_scl": sum(d.stage == "scl" for d in details.values()),
            "rungs": [{"rows": r, "L": L, "n_rows": k, "s": t}
                      for r, L, k, t in rv.scl_rungs], "verdicts": v})
    acc = {m: runs[m][0]["accept"] for m in runs}
    for m in runs:
        check(runs[m][0]["verdicts"].tolist() == runs[m][1]["verdicts"].tolist(),
              f"{m} ladder verdicts differ between its two runs")
    slack = _slack(acc["exact"], B)
    check(acc["serving"] >= float(hard.mean()),
          f"serving ladder accept {acc['serving']} below hard {hard.mean()}")
    check(acc["serving"] >= acc["exact"] - slack,
          f"serving ladder accept {acc['serving']} below exact "
          f"{acc['exact']} - {slack}")
    with scl_env(SERVING="1", IMPL=None):
        v_cpu = cpu.verify_batch(ladder_clips[:N_CPU_LADDER],
                                 nv[:N_CPU_LADDER].cpu())
        bad = RobustBatchVerifier(BAD_KEY)
        bad_acc = bad.verify_batch(clips, nv)
    want = runs["serving"][0]["verdicts"][:N_CPU_LADDER].tolist()
    check(v_cpu.tolist() == want,
          f"serving ladder verdicts card {want} cpu {v_cpu.tolist()}")
    check(not bad_acc.any(),
          f"{int(bad_acc.sum())} wrong-key clips accepted by the serving ladder")
    del bad, clips
    for m in runs:
        for r in runs[m]:
            del r["verdicts"]
    line["ladder"] = {"B": B, "snr_db": 4.0, "hard_accept": float(hard.mean()),
                      "exact_accept": acc["exact"],
                      "serving_accept": acc["serving"], "slack": slack,
                      "runs": runs, "cpu_clips": N_CPU_LADDER,
                      "cpu_verdicts_equal": True, "wrong_key_accepted": 0,
                      "launches_serving_runs": launches_ladder}

    # ---- (c) recovery -----------------------------------------------------
    scaled_np, nvs, exact_line = recover_batch
    scaled = torch.from_numpy(scaled_np).cuda()
    with scl_env(SERVING="1", IMPL=None), no_card_walk():
        build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tracing() as tr:
            rec = rv.verify_batch_recover(scaled, nvs)
        rec_s = time.perf_counter() - t0
        launches_rec = decode_launches(build.LAUNCHES)
        serving_launches("serving_recover", build.LAUNCHES)
    log = rv.recover_log
    secs = _recover_seconds(tr.drain())
    del scaled
    rec_accept = float(rec.mean())
    check(rec_accept >= RECOVER_GATE,
          f"serving recovery accept {rec_accept} < {RECOVER_GATE}")
    exact2 = exact_line["second_call"]
    line["recover"] = {
        "B": B, "factor": SCALE, "gate": RECOVER_GATE,
        "serving_accept": rec_accept, "exact_accept": exact_line["accept"],
        "serving_s": rec_s, "exact_second_call_s": exact2["seconds"],
        "serving_rounds": [{**{k: r[k] for k in (
            "rows", "host_rows", "dens", "accepted")}, "s": t,
            "scl_s": scl, "scl_share": scl / max(t, 1e-9)}
            for r, t, scl in zip(log["rounds"], secs["rounds_s"],
                                 secs["rounds_scl_s"])],
        "serving_scl_s": sum(secs["rounds_scl_s"]),
        "exact_scl_s": exact2["scl_s"],
        "exact_rounds_s": exact2["rounds_s"]}

    # ---- (d) single clips -------------------------------------------------
    rng = np.random.default_rng(SEED + 27)
    noise = (0.1 * rng.standard_normal(T35)).astype(np.float32)
    single = {}
    launches_single = 0
    for tier, make, stream, span in (
            ("compat", lambda: WatermarkDetector(KEY), compat_stream,
             "rx.scl"),
            ("v2", lambda: RobustVerifier(KEY), v2_stream, "rx.v2.scl")):
        s0 = int(rng.integers(0, stream.size - T35))
        out = {"noise": {"exact": [], "serving": []}}
        # the rejected clip in turns, each on a fresh verifier
        for mode in TURNS[:4]:
            with scl_env(IMPL="serving" if mode == "serving" else None,
                         SERVING=None), no_card_walk():
                det = make()
                Timer.registry.clear()
                build.LAUNCHES.clear()
                r, dt = _timed(lambda: det.verify_detailed(noise, FS), torch)
                if mode == "serving":
                    launches_single += decode_launches(build.LAUNCHES)
                    serving_launches("serving_single", build.LAUNCHES)
                else:
                    check(build.LAUNCHES.get("scl_serving", 0) == 0,
                          f"exact {tier} clip launched the serving kernel")
                    scl_launches("serving_phase_exact_single",
                                 build.LAUNCHES)
            scl_s = _timer_totals(Timer).get(span, {}).get("total_s", 0.0)
            check(not r.authentic, f"{mode} {tier} noise clip accepted: {r}")
            check(scl_s > 0, f"{mode} {tier} noise clip ran no SCL pass")
            out["noise"][mode].append({"seconds": dt, "scl_s": scl_s})
        with scl_env(IMPL="serving", SERVING=None), no_card_walk():
            det = make()
            build.LAUNCHES.clear()
            r, dt = _timed(lambda: det.verify_detailed(
                stream[s0:s0 + T35], FS), torch)
            launches_single += decode_launches(build.LAUNCHES)
            serving_launches("serving_single", build.LAUNCHES, least=0)
        check(r.authentic, f"serving {tier} cut at {s0} rejected: {r}")
        out["cut"] = {"authentic": True, "stage": r.stage, "seconds": dt}
        single[tier] = out
    single["compat"]["noise"]["exact_phase16_s"] = compat_rejects["noise"]
    line["single"] = single
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    return {"serving_ladder": launches_ladder,
            "serving_recover": launches_rec,
            "serving_single": launches_single}


def main() -> None:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    for name in SCL_SWITCHES:          # phases 1-25 run the exact decoder
        os.environ.pop(name, None)
    try:
        from echoseal_torch.ops import build, llr
    except ImportError as e:
        check(False, f"echoseal_torch not importable ({e}); run from the "
                     "repository root")

    # ---- 1. environment --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "env", "card": card, "device": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ---- 2. kernel build ---------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [str(p.name) for p in libs.values()]})

    # ---- 3. kernels vs their plain versions --------------------------------
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    busy, mhz = busy_cycles(torch)
    llr_err, llr_entry = kernel_phase(torch, llr, flush, busy, mhz)
    decode_err, decode_entry = decode_kernel_phase(torch, llr, flush, busy)
    scl_err, scl_entry = scl_kernel_phase(torch, flush, busy)
    serving_err, serving_entry = serving_kernel_phase(torch, flush, busy)
    sync_err, sync_entry = sync_kernel_phase(torch, flush, busy)
    scan_err, scan_entry = scan_kernel_phase(torch, flush, busy)
    resample_err, resample_entry = resample_kernel_phase(torch, flush, busy)
    del flush

    by_path = {}
    by_path["compat"], bv, host_frames, starts = compat_phases(torch, card)
    by_path["v2"], rv, cpu, stream, ladder_clips = v2_phases(torch, card)
    by_path["tx_device_verify"] = tx_phase(torch, card, bv, host_frames)
    (by_path["ingest_44k1"], by_path["timescale_recover"],
     recover_batch) = recover_phases(torch, card, rv, cpu, stream)
    torch.cuda.empty_cache()
    (by_path["compat_single"], compat_stream,
     compat_rejects) = compat_single_phase(torch, card)
    by_path["v2_single"], v2_stream = v2_single_phase(torch, card)
    (by_path["stream_monitors"], by_path["batch_monitor"],
     by_path["verifier_pool"]) = monitor_pool_phase(torch, card, v2_stream)
    device_pair_phase(torch, card, compat_stream, v2_stream)
    impaired, llr_by_path = impaired_phases(torch, card, bv, host_frames,
                                            rv, cpu, stream)
    by_path.update(impaired)
    by_path.update(native_gui_phase(torch, card))
    by_path.update(sharded_phase(torch, card, bv, host_frames, starts, rv,
                                 stream))
    del bv, host_frames, stream
    by_path.update(scl_serving_phase(torch, card, rv, cpu, ladder_clips,
                                     recover_batch, compat_stream, v2_stream,
                                     compat_rejects))
    del rv, cpu, ladder_clips, recover_batch
    for path in ("native_tx", "gui_rx", "sharded_compat", "sharded_v2",
                 "serving_ladder", "serving_recover", "serving_single"):
        check(by_path[path] > 0, f"payload_decode never launched on {path}")
    for path in SCL_PATHS:
        check(SCL_BY_PATH.get(path, 0) > 0,
              f"scl_decode never launched on {path}: {SCL_BY_PATH}")
    for path in SERVING_PATHS:
        check(SERVING_BY_PATH.get(path, 0) > 0,
              f"scl_serving never launched on {path}: {SERVING_BY_PATH}")
    for entry, paths, err in ((decode_entry, by_path, decode_err),
                              (llr_entry, llr_by_path, llr_err),
                              (scl_entry, SCL_BY_PATH, scl_err),
                              (serving_entry, SERVING_BY_PATH, serving_err),
                              (sync_entry, SYNC_BY_PATH, sync_err),
                              (scan_entry, SCAN_BY_PATH, scan_err),
                              (resample_entry, RESAMPLE_BY_PATH,
                               resample_err)):
        entry["launches"] = sum(paths.values())
        entry["launches_by_path"] = paths
        entry["max_abs_err"] = err
    print(json.dumps({"kernels": [decode_entry, llr_entry, scl_entry,
                                  serving_entry, sync_entry, scan_entry,
                                  resample_entry]}),
          flush=True)

    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
