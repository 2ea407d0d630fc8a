"""Multi-rank dry run: the sharded TX -> RX -> recovery loop, strictly held.

Run ``python -m echoseal_torch.parallel.dryrun N [--device cpu]``.  It
starts N ranks with ``torch.multiprocessing.spawn`` and joins them in one
process group over ``tcp://127.0.0.1:<free port>``: ``nccl`` with one CUDA
card per rank by default (a host with fewer than N cards, or none, fails),
``gloo`` on the CPU with ``--device cpu``.  Rank 0 prints the marker

    DRYRUN_OK n_devices=N verdicts=[...] n_crc_ok=.. v2_verdicts=[...]
    v2_n_crc_ok=.. recovered=N

once every leg has passed; any failed check raises and the command exits
nonzero.  The legs, as in the JAX package's dry run:

* sharded TX: 6 frames per rank through ``shard_tx``; shape, finite,
  non-silent, the 63 preamble chips equal to ``BatchEmbedder``'s;
* compat verify (``shard_verify``, ``T = 1 << 13``, ``max_ctr`` 64): the
  all-reduced CRC count >= N, every clip AEAD-verifies under the session
  nonce, and a wrong-nonce replay rejects every clip;
* v2 verify (``shard_verify_v2``, ``T2 = 1 << 15``) through the full host
  ladder ``_finish_ladder``, with its replay;
* recovery: every clip played 3.1 % fast, the sharded scale scan, then the
  sharded resample and re-verify over the lattice bracket [k, k-1, k+1]:
  every clip must come back.

The parent designs the verifiers' host tables and the scan bank once
(seconds of float64 work) and hands them to every rank, which builds its
verifiers on them with ``from_tables``.

Each rank also holds its gathered outputs equal to an unsharded run of the
whole batch on its own device, with no collective: integers and bools
exactly, floats within 1e-6 of the largest magnitude of the output.  That
run takes the batch in the ranks' row chunks, since a float32 GEMM may
round differently at another row count (ROADMAP C1); verdicts are also
held row-identical to one call on the whole batch.  The TX randomness is
drawn from ``numpy.random.default_rng(SEED)``, the same on every rank.
"""
from __future__ import annotations

import argparse
import socket
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

FRAMES_PER_CLIP = 6
SEED = 2024
FS = 48_000
MAX_CTR = 64
FLOAT_TOL = 1e-6
KEY = bytes.fromhex("aa" * 32)
NONCE = b"dryrun!!"


def _check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _same(got: dict, want: dict, what: str) -> None:
    """Each of ``want``'s outputs equals the gathered one: integers, bools
    and non-finite floats exactly, finite floats within FLOAT_TOL of the
    output's largest finite value (at least 1)."""
    for k, w in want.items():
        g = got[k]
        _check(g.shape == w.shape and g.dtype == w.dtype,
               f"{what} {k}: {g.dtype}{tuple(g.shape)} sharded, "
               f"{w.dtype}{tuple(w.shape)} unsharded")
        if w.is_floating_point():
            fin = torch.isfinite(w)       # -inf marks masked peaks
            _check(torch.equal(torch.isfinite(g), fin) and torch.equal(
                g[~fin].nan_to_num(), w[~fin].nan_to_num()),
                f"{what} {k}: non-finite entries differ")
            scale = max(float(w[fin].abs().max()), 1.0) if fin.any() else 1.0
            diff = torch.where(fin, g - w, 0.0).abs()
            err = float(diff.max()) if diff.numel() else 0.0
            if err > FLOAT_TOL * scale:
                at = tuple(int(i) for i in np.unravel_index(
                    int(diff.argmax()), tuple(diff.shape)))
                lag = ""
                if k == "peak_val" and "peak_idx" in want:   # a peak's lag
                    lag = (f", lag {int(got['peak_idx'][at])} sharded, "
                           f"{int(want['peak_idx'][at])} unsharded")
                _check(False, f"{what} {k}: sharded differs from unsharded "
                              f"by {err} (tolerance {FLOAT_TOL * scale}) at "
                              f"row {at[0]}, index {at[1:]} of "
                              f"{tuple(w.shape)}{lag}: sharded "
                              f"{float(g[at])!r}, unsharded "
                              f"{float(w[at])!r}")
        else:
            _check(torch.equal(g, w), f"{what} {k}: sharded != unsharded")


def _unsharded(fn, n_ranks: int, *batch):
    """``fn`` over the whole batch on this device alone, one call per
    rank's row chunk, the results concatenated (tensors or dicts)."""
    per = batch[0].shape[0] // n_ranks
    parts = [fn(*(a[r * per:(r + 1) * per] for a in batch))
             for r in range(n_ranks)]
    if isinstance(parts[0], dict):
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    return torch.cat(parts)


def _same_stage(got: dict, want: dict, what: str) -> None:
    """A sharded stage's dict equals the unsharded run's, and its
    all-reduced ``n_crc_ok`` the unsharded CRC-pass count."""
    _check(set(got) == set(want) | {"n_crc_ok"}, f"{what}: {sorted(got)}")
    _same(got, want, what)
    n = int(want["crc_ok"].sum())
    _check(int(got["n_crc_ok"]) == n,
           f"{what}: all-reduced n_crc_ok {int(got['n_crc_ok'])} != {n}")


def design_tables() -> dict:
    """The compat and v2 verifiers' host tables for ``KEY`` at ``MAX_CTR``
    and the time-scale scan's template bank, as CPU tensors: designed in
    three threads, since BLAS and scipy's filters release the interpreter
    lock.  ``torch.multiprocessing`` hands tensors to the ranks as
    shared-memory handles; a pickled copy of the 360 MB v2 tables would
    hold each rank's start until the rank before it had read its copy."""
    from echoseal_torch.core.bandplan import hop_schedule
    from echoseal_torch.core.crypto import SecureChannel
    from echoseal_torch.core.profiles import ROBUST
    from echoseal_torch.models.pipeline import host_tables, host_tables_v2
    from echoseal_torch.models.robust import scaled_template_bank

    sec, hop = SecureChannel(KEY), hop_schedule(KEY)
    with ThreadPoolExecutor(3) as ex:
        jobs = [ex.submit(host_tables, sec, hop, FS, MAX_CTR),
                ex.submit(host_tables_v2, sec, hop, FS, MAX_CTR),
                ex.submit(scaled_template_bank, FS, ROBUST.oversample)]
    compat, v2, bank = (job.result() for job in jobs)
    return {"compat": {k: torch.from_numpy(v) for k, v in compat.items()},
            "v2": {k: torch.from_numpy(v) for k, v in v2.items()},
            "scan_bank": torch.from_numpy(bank)}


def run(mesh, tables: dict) -> str:
    """Drive every leg on this rank with verifiers on ``tables`` (those of
    ``design_tables``); returns the marker line."""
    from echoseal_torch.core.params import FRAME_LEN, HDR_L, PRE_L
    from echoseal_torch.core.sequences import (
        bits_to_bpsk,
        header_bits_batch,
        mls63,
    )
    from echoseal_torch.models.embedder import (
        BatchEmbedder,
        _seal_frames,
        db_to_lin,
        synthesize_frames_device,
    )
    from echoseal_torch.models.pipeline import (
        BatchVerifier,
        RobustBatchVerifier,
    )
    from echoseal_torch.models.robust import (
        SCALE_SCAN_GRID,
        RobustEmbedder,
        _scale_scan_batch,
        device_scan_bank,
    )
    from echoseal_torch.ops import demod
    from echoseal_torch.parallel.mesh import (
        shard_resample_v2,
        shard_scan_v2,
        shard_tx,
        shard_verify,
        shard_verify_v2,
    )
    from echoseal_torch.utils import channels

    n_dev, dev = mesh.world_size, mesh.device
    rng = np.random.default_rng(SEED)

    # ---- sharded TX: FRAMES_PER_CLIP frames per rank ----------------------
    be = BatchEmbedder(KEY, device=dev)
    ctrs = np.arange(n_dev * FRAMES_PER_CLIP, dtype=np.int64)
    blobs = _seal_frames(be.sec, ctrs, NONCE, rng)
    info = np.unpackbits(np.frombuffer(b"".join(blobs), np.uint8).reshape(
        ctrs.size, -1), axis=-1)
    tx_in = (info, header_bits_batch(ctrs),
             be.sec.pn_bits_batch(ctrs, FRAME_LEN)[:, PRE_L + HDR_L:],
             bits_to_bpsk(be.sec.pn_bits(0, HDR_L)).astype(np.float32),
             bits_to_bpsk(mls63()).astype(np.float32), be._hop.indices(ctrs),
             demod.all_forward_matrices(be.p.fs).astype(np.float32))
    frames = shard_tx(mesh)(*tx_in)
    _check(frames.shape == (ctrs.size, FRAME_LEN), f"TX {frames.shape}")
    _check(bool(torch.isfinite(frames).all()), "TX produced non-finite chips")
    _check(bool((frames.amax(-1) > frames.amin(-1)).all()),
           "TX produced silent frames")
    info_d, hdr_d, pn_d, hdr_pn_sy, pre_sy, band_d, t_fwd = (
        torch.as_tensor(a, device=dev) for a in tx_in)
    whole = _unsharded(
        lambda i, h, p, b: synthesize_frames_device(i, h, p, hdr_pn_sy,
                                                    pre_sy, b, t_fwd),
        n_dev, info_d, hdr_d, pn_d, band_d)
    _same({"frames": frames}, {"frames": whole}, "tx")
    # fresh seals differ, but the deterministic preamble must match the
    # unsharded TX exactly
    ref = be.frames(ctrs[:FRAMES_PER_CLIP], session_nonce=NONCE, rng=rng)
    np.testing.assert_allclose(frames[:FRAMES_PER_CLIP, :63].cpu().numpy(),
                               ref[:, :63], rtol=1e-5, atol=1e-6)

    # ---- sharded compat verify: one clip per rank -------------------------
    T = 1 << 13                   # 8192 > 6 frames = 7290
    clips = np.zeros((n_dev, T), dtype=np.float32)
    stream = frames.cpu().numpy().reshape(n_dev, FRAMES_PER_CLIP * FRAME_LEN)
    clips[:, :stream.shape[1]] = stream * db_to_lin(be.p.floor_rel_dbfs)
    n_valid = np.full(n_dev, T, dtype=np.int32)
    bv = BatchVerifier.from_tables(KEY, tables["compat"], device=dev)
    out = shard_verify(bv, mesh)(clips, n_valid)
    _same_stage(out, _unsharded(bv.run_device, n_dev, clips, n_valid),
                "compat")
    _check(out["crc_ok"].shape[0] == n_dev, "compat: rows lost")
    n_crc_ok = int(out["n_crc_ok"])
    _check(n_crc_ok >= n_dev,
           f"all-reduced CRC pass count {n_crc_ok} < {n_dev} clips")
    verdicts = bv.finish_host(out, expected_nonce=NONCE)
    failed = np.flatnonzero(~verdicts)
    _check(verdicts.shape == (n_dev,) and failed.size == 0,
           f"clips {failed.tolist()} failed AEAD verification "
           f"(per-clip ok={out['ok'].tolist()})")
    one_call = bv.finish_host(bv.run_device(clips, n_valid),
                              expected_nonce=NONCE)
    _check(one_call.tolist() == verdicts.tolist(),
           f"compat verdicts {verdicts.tolist()} sharded, "
           f"{one_call.tolist()} in one call")
    replay = bv.finish_host(out, expected_nonce=b"someone!")
    _check(not replay.any(), "anti-replay nonce check accepted a replay")

    # ---- sharded v2 verify ------------------------------------------------
    tx2 = RobustEmbedder(KEY, rng=rng)
    tx2._session_nonce = NONCE
    span = tx2.profile.span
    T2 = 1 << 15                  # 3 v2 frames = 29160
    stream2 = tx2.process(np.zeros((3 + n_dev) * span, dtype=np.float32))
    # one clip per rank, each cut at a different frame counter so that the
    # header's absolute counter resolution runs on every rank
    clips2 = np.stack([stream2[d * span: d * span + T2]
                       for d in range(n_dev)])
    nv2 = np.full(n_dev, T2, dtype=np.int32)
    bv2 = RobustBatchVerifier.from_tables(KEY, tables["v2"], device=dev)
    bv2._scan_bank = device_scan_bank(tables["scan_bank"].numpy(), dev)
    run2 = shard_verify_v2(bv2, mesh)
    out2 = run2(clips2, nv2)
    _same_stage(out2, _unsharded(bv2.run_device, n_dev, clips2, nv2), "v2")
    _check(out2["host_packed"].shape == (n_dev, 65),
           "the v2 host row must carry the evidence bytes")
    n_crc2 = int(out2["n_crc_ok"])
    _check(n_crc2 >= n_dev,
           f"v2 all-reduced CRC pass count {n_crc2} < {n_dev} clips")
    v2_verdicts = bv2._finish_ladder(out2, NONCE, True, 1 << 20)
    failed2 = np.flatnonzero(~v2_verdicts)
    _check(failed2.size == 0,
           f"v2 clips {failed2.tolist()} failed AEAD verification "
           f"(per-clip ok={out2['ok'].tolist()})")
    one_call2 = bv2._finish_ladder(bv2.run_device(clips2, nv2), NONCE, True,
                                   1 << 20)
    _check(one_call2.tolist() == v2_verdicts.tolist(),
           f"v2 verdicts {v2_verdicts.tolist()} sharded, "
           f"{one_call2.tolist()} in one call")
    replay2 = bv2._finish_ladder(out2, b"someone!", False, 1 << 20)
    _check(not replay2.any(), "v2 anti-replay accepted a wrong session nonce")

    # ---- sharded recovery: scan -> resample -> re-verify ------------------
    true_s = 1.031
    clips3 = np.zeros((n_dev, T2), dtype=np.float32)
    nv3 = np.zeros(n_dev, dtype=np.int32)
    for d in range(n_dev):
        y = channels.time_scale(clips2[d].copy(), true_s)
        L = min(y.size, T2)
        clips3[d, :L] = y[:L]
        nv3[d] = L
    v3 = bv2._finish_ladder(run2(clips3, nv3), NONCE, True, 1 << 20)

    scan = shard_scan_v2(bv2, mesh)
    scores = scan(clips3, nv3)
    bank = bv2._device_scan_bank()
    _same({"scores": scores}, {"scores": _unsharded(
        lambda x, n: _scale_scan_batch(torch.as_tensor(x, device=dev),
                                       torch.as_tensor(n, device=dev), bank),
        n_dev, clips3, nv3)}, "scan")
    per = scores.cpu().numpy().reshape(n_dev, len(SCALE_SCAN_GRID), 4).max(2)
    f = np.asarray(SCALE_SCAN_GRID)[np.argmax(per, axis=1)]
    f_med = float(np.median(f))
    _check(abs(f_med * true_s - 1.0) < 4e-3,
           f"sharded scan argmaxed {f_med}, want ~{1.0 / true_s:.5f}")

    # per-clip correction factors (identity picks take the batch median),
    # then up to 3 sharded retry rounds over the scan pick's lattice
    # neighbours: 3-frame clips carry too few sync peaks for the serving
    # ladder's inter-peak refinement, and the scan grid's step is ~40
    # lattice steps, so the true rational is within one step of the pick
    res = shard_resample_v2(bv2, mesh, T2)
    rs = bv2._device_resampler(T2)
    factors = np.where(np.abs(f - 1.0) <= 1e-4, f_med, f)
    k_scan = np.round(bv2.RETRY_UP * factors).astype(np.int64)
    recovered = v3.copy()
    for step in (0, -1, +1):
        dens: dict[int, list[int]] = {}
        for d in np.flatnonzero(~recovered):
            k = int(k_scan[d] + step)
            if k != bv2.RETRY_UP:
                dens.setdefault(k, []).append(d)
        if not dens:
            break
        clips3r = np.zeros((n_dev, T2), dtype=np.float32)
        nv3r = np.zeros(n_dev, dtype=np.int32)
        for den, members in dens.items():
            yr, n_out = res(clips3, den)
            y_whole = _unsharded(
                lambda x: rs(torch.as_tensor(x, device=dev), den)[0],
                n_dev, clips3)
            _same({"y": yr}, {"y": y_whole}, "resample")
            yr_np = yr.cpu().numpy()
            L = min(n_out, T2)
            for d in members:
                clips3r[d, :L] = yr_np[d, :L]
                nv3r[d] = min((int(nv3[d]) * bv2.RETRY_UP) // den, L)
        v4 = bv2._finish_ladder(run2(clips3r, nv3r), NONCE, True, 1 << 20,
                                real=nv3r > 0)
        recovered |= v4
    n_rec = int(recovered.sum())
    _check(n_rec == n_dev,
           f"sharded recovery lost clips "
           f"{np.flatnonzero(~recovered).tolist()} (pre-scan verdicts "
           f"{v3.astype(int).tolist()}, factors "
           f"{[round(float(x), 5) for x in factors]})")

    return (f"DRYRUN_OK n_devices={n_dev} "
            f"verdicts={verdicts.astype(int).tolist()} n_crc_ok={n_crc_ok} "
            f"v2_verdicts={v2_verdicts.astype(int).tolist()} "
            f"v2_n_crc_ok={n_crc2} recovered={n_rec}")


def _worker(rank: int, world: int, init_method: str, on_cpu: bool,
            tables: dict) -> None:
    """One rank: join the group, run every leg, leave the group."""
    from echoseal_torch.parallel.mesh import streams_mesh

    if on_cpu:
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world)
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, rank=rank,
                                world_size=world, device_id=dev)
    try:
        marker = run(streams_mesh(device="cpu" if on_cpu else None), tables)
        dist.barrier()
        if rank == 0:
            print(marker, flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m echoseal_torch.parallel.dryrun",
        description="sharded TX -> RX -> recovery over N ranks")
    p.add_argument("n", type=int, nargs="?", default=1,
                   help="number of ranks (one device each)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: nccl, one card per rank; cpu: gloo")
    args = p.parse_args(argv)
    if args.n < 1:
        raise SystemExit("need at least one rank")
    on_cpu = args.device == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to run the "
                             "ranks on the CPU")
        if args.n > torch.cuda.device_count():
            raise SystemExit(f"{args.n} ranks need {args.n} CUDA cards, "
                             f"this host has {torch.cuda.device_count()}")
    init = f"tcp://127.0.0.1:{_free_port()}"
    torch.multiprocessing.spawn(_worker,
                                args=(args.n, init, on_cpu, design_tables()),
                                nprocs=args.n, join=True)


if __name__ == "__main__":
    main()
