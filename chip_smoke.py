#!/usr/bin/env python3
"""Drive echoseal_torch's main path on one NVIDIA GPU and check every result.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, nvcc and nvidia-smi, and no network.  Phases, each
printing one JSON line (any failed check exits nonzero before the last
line):

1. environment: the card (``nvidia-smi`` name and power limit, also
   printed raw on a line of its own), torch and CUDA versions;
2. kernel build: every ``echoseal_torch/csrc/*.cu`` with nvcc, in parallel;
3. kernels: each kernel's wrapper against its plain torch version on the
   card at the main path's shapes (and a ragged one), with CUDA-event
   times and the memory/compute bound -- printed as ``{"kernels": [...]}``;
4. main path at full width: a 4096-frame stream from the port's host TX
   (every random byte drawn from ``SEED``), B = 1024 clips of 3 s at 48 kHz cut at frame-aligned random starts,
   ``BatchVerifier(max_ctr=16384, peaks=2).verify_batch``; every clip must
   verify and the kernel must have launched; 64 noise clips and the same
   clips under a wrong key must all reject; a clip cut at counter 70 000
   must verify only through the extended-counter pass;
5. timing: one warm-up and 3 timed ``run_device`` + ``finish_host`` runs,
   real-time factor and per-stage CUDA-event times;
6. the same 4 clips through the port on the card and on the CPU.

The last line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

KEY = bytes.fromhex("aa" * 32)
FS = 48_000
B = 1024
CLIP_S = 3
T = CLIP_S * FS
TPAD = T + 8192
STREAM_FRAMES = 4096
MAX_CTR = 16_384
PEAKS = 2
SEED = 0
KERNEL_TOL = 1e-4
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


def main() -> None:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    try:
        from echoseal_torch.core.params import FRAME_LEN
        from echoseal_torch.models import pipeline as pl
        from echoseal_torch.models.embedder import frames_np
        from echoseal_torch.ops import build, demod, llr
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
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    entry = None
    max_err = 0.0
    for lead in ((13,), (B, 4, PEAKS)):
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
        emit({"phase": "kernel_check", "name": "payload_llr", "rows": n,
              "max_abs_err": err})
        if n == B * 4 * PEAKS:
            n_bytes = 3 * n * 1024 * 4          # chips + pn read, llr written
            n_ops = 12 * n * 1024               # ~12 fp32 ops per element
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = n_ops / FP32_FLOP_PER_S * 1e3
            entry = {
                "name": "payload_llr", "route": "cuda",
                "source": "echoseal_torch/csrc/payload_llr.cu",
                "replaces": "echoseal_tpu/ops/pallas/llr_kernel.py:51",
                "launches": None, "max_abs_err": None,
                "ms": cuda_ms(lambda: llr.payload_llr(chips, pn), torch,
                              flush=flush),
                "plain_ms": cuda_ms(lambda: llr.payload_llr_plain(chips, pn),
                                    torch, flush=flush),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
            }
    del flush

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
    check(launches.get("payload_llr", 0) > 0, "payload_llr never launched")
    entry["launches"] = launches["payload_llr"]
    entry["max_abs_err"] = max_err
    print(json.dumps({"kernels": [entry]}), flush=True)

    noise = 0.05 * torch.randn(64, TPAD, device="cuda", generator=gen)
    noise_acc = bv.verify_batch(noise, torch.full_like(nv[:1], T).expand(64))
    check(not noise_acc.any(), f"{int(noise_acc.sum())} noise clips accepted")
    bad = pl.BatchVerifier(bytes.fromhex("99" * 32), max_ctr=MAX_CTR,
                           peaks=PEAKS)
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
            prev, stages = start, {}
            for nm, ev in marks:
                stages[nm] = prev.elapsed_time(ev)
                prev = ev
            stages["sync"] = stages["sync_xcorr"] + stages["sync_nms"]
            best = {"total_s": t2 - t0, "device_s": t1 - t0,
                    "host_finish_s": t2 - t1, "stage_ms": stages}
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

    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
