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
   card at both paths' shapes (and a ragged one), with CUDA-event times and
   the memory/compute bound;
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
11. the same 4 v2 clips through the port on the card and on the CPU.

Before the last line it prints ``{"kernels": [...]}``: each kernel at the
v2 path's shape, with its launches counted over both main paths.  The last
line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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
KERNEL_TOL = 1e-4
N_CPU_LADDER = 16             # SCL-ladder clips re-verified on the CPU
N_SCL256 = 128
N_CPU_SCL256 = 8
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
        raise SystemExit(1)


def cuda_ms(fn, torch, n: int = 25, flush=None) -> float:
    """Median CUDA-event time of ``fn`` over ``n`` launches (after a warm-up)."""
    fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()              # evict L2 (50 MB) between launches
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def stage_ms(start, marks) -> dict[str, float]:
    """CUDA-event ms of each marked stage, from ``start`` on."""
    prev, out = start, {}
    for nm, ev in marks:
        out[nm] = prev.elapsed_time(ev)
        prev = ev
    out["sync"] = out["sync_xcorr"] + out["sync_nms"]
    return out


def kernel_phase(torch, llr, flush):
    """Phase 3: payload_llr vs its plain version at every path's shape.

    Returns (max error over all shapes, the v2-shape ``kernels`` entry).
    """
    from echoseal_torch.core.params import FRAME_LEN

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entry, max_err = None, 0.0
    for lead in ((13,), (B, 4, PEAKS), (B, 4, V2_NP, V2_PEAKS)):
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
            line.update(
                ms=cuda_ms(lambda: llr.payload_llr(chips, pn), torch,
                           flush=flush),
                plain_ms=cuda_ms(lambda: llr.payload_llr_plain(chips, pn),
                                 torch, flush=flush),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
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


def compat_phases(torch, card):
    """Phases 4-6; returns the kernel launches of the compat main path."""
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
    n_frames = -(-T // FRAME_LEN)
    rng = np.random.default_rng(SEED)
    stream = torch.from_numpy(frames_np(
        bv.sec, bv._hop, np.arange(STREAM_FRAMES), bytes(8),
        rng=rng).reshape(-1))
    starts = rng.integers(0, STREAM_FRAMES - n_frames, B) * FRAME_LEN
    scale = 10.0 ** (-35.0 / 20.0)
    clips = torch.zeros(B, TPAD, device="cuda")
    clips[:, :T] = demod.slice_windows(
        stream.cuda(), torch.from_numpy(starts).cuda(), T) * scale
    nv = torch.full((B,), T, dtype=torch.int32, device="cuda")
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
    check(launches.get("payload_llr", 0) > 0,
          "payload_llr never launched on the compat path")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    noise = 0.05 * torch.randn(64, TPAD, device="cuda", generator=gen)
    noise_acc = bv.verify_batch(noise, torch.full_like(nv[:1], T).expand(64))
    check(not noise_acc.any(), f"{int(noise_acc.sum())} noise clips accepted")
    bad = pl.BatchVerifier(BAD_KEY, max_ctr=MAX_CTR, peaks=PEAKS)
    bad_acc = bad.verify_batch(clips, nv)
    check(not bad_acc.any(), f"{int(bad_acc.sum())} wrong-key clips accepted")
    del bad
    far = np.zeros((1, TPAD), np.float32)
    far[0, :T] = frames_np(bv.sec, bv._hop, np.arange(70_000, 70_000 + n_frames),
                           bytes(8), rng=rng).reshape(-1)[:T] * scale
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
    return launches["payload_llr"]


def _v2_stream(torch, rng, host):
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
    """Phases 7-11; returns the kernel launches of the v2 main path."""
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
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(STREAM_S_V2 * FS) / FS)
            ).astype(np.float32)
    _, starts, clips = _v2_stream(torch, rng, host)
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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    accept = float(verdicts.mean())
    check(accept == 1.0,
          f"v2 accept rate {accept}: rejected clips "
          f"{np.flatnonzero(~verdicts).tolist()} at samples "
          f"{starts[~verdicts].tolist()}")
    check(launches.get("payload_llr", 0) > 0,
          "payload_llr never launched on the v2 path")
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
    _, _, sil = _v2_stream(torch, rng, np.zeros(STREAM_S_V2 * FS, np.float32))
    rms = float(torch.sqrt(torch.mean(sil[:, :T] ** 2)))
    sil[:, :T] += rms * 10 ** (-4 / 20) * torch.randn(B, T, device="cuda",
                                                       generator=gen)
    t0 = time.perf_counter()
    hard = rv.verify_batch(sil, nv, use_scl=False)
    hard_s = time.perf_counter() - t0
    details = {}
    t0 = time.perf_counter()
    full = rv.verify_batch(sil, nv, details=details)
    full_s = time.perf_counter() - t0
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
          "rungs": [{"rows": r, "L": L, "n_rows": n, "s": s}
                    for r, L, n, s in rungs],
          "cpu_clips": N_CPU_LADDER, "cpu_verdicts_equal": True,
          "cpu_s": cpu_s})
    del sil

    # ---- 10. SCL-256 -----------------------------------------------------------
    spec = polar.polar_spec()
    rng = np.random.default_rng(SEED + 3)
    bits = np.stack([polar.encode_np(rng.bytes(55), spec)
                     for _ in range(N_SCL256)])
    y = (2.0 * bits - 1.0) + 0.3 * rng.standard_normal(bits.shape)
    llr = torch.from_numpy((2.0 * y / 0.09).astype(np.float32)).cuda()
    res = scl.scl_decode(llr, spec, 256)               # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = scl.scl_decode(llr, spec, 256)
        res["crc_ok"].cpu()
        times.append(time.perf_counter() - t0)
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
          "runs_s": times,
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
    return launches["payload_llr"]


def main() -> None:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
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
    max_err, entry = kernel_phase(torch, llr, flush)
    del flush

    launches = compat_phases(torch, card)
    launches += v2_phases(torch, card)
    entry["launches"] = launches
    entry["max_abs_err"] = max_err
    print(json.dumps({"kernels": [entry]}), flush=True)

    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
