"""The comparison that decides ``correct`` for a batch cell.

After the window, the plain reference (``portbench/ref/verify.py``) works
out each distinct batch again and every number below is held to the
cell's limit (``portbench/limits/<workload>.json``):

- ``verdict_mismatch``: clips of every call in the window whose verdict,
  or accepted (session nonce, counter, stage), differs from the reference;
- ``untrue_accept``: accepted clips whose session nonce is not the
  stream's or whose counter is not a frame of the clip;
- ``rejected``: clips of every call rejected, judged by what each clip
  holds: every cut carries whole frames of the stream's session, so on a
  clean channel a reject is a wrong answer (compared in the clean cells);
- ``sync_val_err``: the largest gap between a sync peak value and the
  reference's (float64) value of the same (clip, band, rank);
- ``chips_rel_err``: the largest relative distance of a candidate's chips
  from the reference's chips at the same peak, and ``chips_rel_err_p50``
  the largest over the batches of its median over the candidates;
- ``decode_mismatch``: candidates whose counter, CRC flag or CRC-passing
  bits differ from the reference's decode of the same chips (v2: and
  clips whose soft rows are not the reference's best by LLR quality);
- ``soft_llr_err`` (v2): the largest relative distance of a soft row's
  LLRs, which the ladder decodes, from the reference's LLRs of the row of
  the same clip nearest to it, and ``soft_ctr_mismatch`` the soft rows
  whose counter is not that row's;
- ``scl_mismatch`` (v2): ladder rows whose CRC-passing paths, in list
  order, differ from the reference walk's on the same rows, and rungs
  that only one side ran.

Beside them, never compared: ``wrong``, the clips counted by
``verdict_mismatch`` or ``untrue_accept``, each once (the run's failed
operations).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.ref import verify as ref

# medians and counts beside the compared numbers, for the readings that
# set the limits (``portbench/calibrate.py``); never compared
DIAG: dict = {}
# calibration only: also read the reference's own soft rows computed in
# bfloat16 against the float64 ones (the soft rows' control)
LLR_CONTROL = False
# the numbers taken from the verdicts alone
VERDICT_NUMS = ("verdict_mismatch", "untrue_accept", "rejected", "wrong")


def _max_or_zero(t: torch.Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


def sync_err(got_val: torch.Tensor, want_val: torch.Tensor) -> float:
    """The largest gap between the best sync peak of each (clip, band)
    and the reference's.  Only the best: the later peaks of the greedy
    suppression follow the earlier picks, so a near-tie between two lags
    moves them by a peak's height, not by a rounding."""
    g = got_val[..., 0].to(torch.float64)
    w = want_val[..., 0].to(torch.float64)
    both = torch.isfinite(g) & torch.isfinite(w)
    if bool((torch.isfinite(g) != torch.isfinite(w)).any()):
        return float("inf")
    return _max_or_zero(torch.abs(g - w)[both])


def chips_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """The largest and the median relative distance of the candidates'
    chips from the reference's."""
    d = torch.linalg.vector_norm(got.to(torch.float64) - want, dim=-1)
    n = torch.linalg.vector_norm(want, dim=-1)
    r = (d / torch.clamp(n, min=1e-30)).flatten()
    DIAG.setdefault("chips_rel_err_p99", []).append(
        float(torch.quantile(r.float(), 0.99)))
    return _max_or_zero(r), float(r.median())


def soft_diff(got_llr: torch.Tensor, got_ctr: torch.Tensor, dec: dict,
              clips: int = 64) -> tuple[float, int]:
    """(``soft_llr_err``, ``soft_ctr_mismatch``): each soft row against the
    reference row of the same clip whose LLRs lie nearest to it (a row of
    the same counter first, on an exact tie); the rows of a near-tie in
    quality may come in either order."""
    err, bad = 0.0, 0
    for c0 in range(0, got_llr.shape[0], clips):
        g = got_llr[c0:c0 + clips].to(torch.float64)           # (b, R, N)
        w = dec["llr_rows"][c0:c0 + clips].to(torch.float64)   # (b, M, N)
        wc = dec["ctr_rows"][c0:c0 + clips].to(torch.int64)
        gc = got_ctr[c0:c0 + clips].to(torch.int64)
        n = torch.linalg.vector_norm(w, dim=-1)                 # (b, M)
        d = torch.linalg.vector_norm(g[:, :, None] - w[:, None], dim=-1)
        rel = d / torch.clamp(n[:, None], min=1e-30)            # (b, R, M)
        other = (gc[:, :, None] != wc[:, None]).to(torch.float64)
        j = torch.argmin(rel + 1e-12 * other, dim=-1)           # (b, R)
        err = max(err, _max_or_zero(torch.gather(rel, -1, j[..., None])))
        bad += int((torch.gather(wc, -1, j) != gc).sum())
    return err, bad


def decode_diff(out: dict, dec: dict) -> int:
    """Candidates whose counter, CRC flag or CRC-passing bits differ; v2:
    clips whose soft rows' LLR quality (mean |LLR|) is not the reference's
    best, beyond float32 rounding (a near-tie may pick another row of
    the same quality)."""
    ctr = out["ctr"].to(torch.int64) != dec["ctr"].to(torch.int64)
    crc = out["crc_ok"] != dec["crc_ok"]
    both = out["crc_ok"] & dec["crc_ok"]
    info = torch.any(out["info_bits"].to(torch.int32)
                     != dec["info_bits"].to(torch.int32), dim=-1) & both
    for k, v in (("ctr", ctr), ("crc", crc), ("info", info)):
        DIAG.setdefault("decode_" + k, []).append(int(v.sum()))
    n = int((ctr | crc | info).sum())
    if "soft_q" in dec:
        got = torch.mean(torch.abs(out["scl_llr"].to(torch.float64)), dim=-1)
        want = dec["soft_q"]
        fin = torch.isfinite(want)
        bad = torch.where(fin, torch.abs(got - want) > 1e-3 * (1 + want.abs()),
                          False).any(dim=-1)
        DIAG.setdefault("decode_soft_q", []).append(int(bad.sum()))
        n += int(bad.sum())
    return n


def scl_diff(got_rungs: list, want_rungs: list) -> int:
    """Rows whose sets of CRC-passing paths differ; a rung on one side
    only counts all of its rows."""
    n = 0
    for k in range(max(len(got_rungs), len(want_rungs))):
        g = got_rungs[k] if k < len(got_rungs) else None
        w = want_rungs[k] if k < len(want_rungs) else None
        if g is None or w is None or g[:2] != w[:2]:
            n += max(r[0] for r in (g, w) if r is not None)
            continue
        n += sum(sorted(a) != sorted(b) for a, b in zip(g[2], w[2]))
    return n


def untrue_accepts(accepts: dict, starts: np.ndarray, stream, T: int) -> set:
    """Accepted clips that say something untrue of their clip."""
    bad = set()
    for i, (nonce, ctr, _) in accepts.items():
        pos = ctr * stream.span - int(starts[i])
        if nonce != stream.nonce or not (
                -stream.span // 2 <= pos <= T - stream.span // 2):
            bad.add(i)
    return bad


@torch.no_grad()
def reference_batch(waveform: str, tab: dict, batch, out: dict,
                    list_size: int | None, peaks: int) -> dict:
    """The reference's numbers and verdicts for one batch, from its clips
    and (past the sync) the program's captured stage outputs."""
    idx, val = ref.sync_peaks(batch.clips, batch.n_valid, tab, peaks)
    nums = {"sync_val_err": sync_err(out["peak_val"], val)}
    del idx, val
    if waveform == "compat":
        chips = ref.compat_chips(batch.clips, out["peak_idx"], tab)
    else:
        chips = ref.v2_chips(batch.clips, out["peak_idx"], tab)
    nums["chips_rel_err"], nums["chips_rel_err_p50"] = chips_err(
        out["chips"], chips)
    del chips
    soft = 0 if waveform == "compat" else out["scl_llr"].shape[1]
    dec = ref.decode(out["chips"], out["peak_idx"], out["peak_val"], tab,
                     soft_rows=soft)
    nums["decode_mismatch"] = decode_diff(out, dec)
    if soft:
        nums["soft_llr_err"], nums["soft_ctr_mismatch"] = soft_diff(
            out["scl_llr"], out["scl_ctr"], dec)
        if LLR_CONTROL:           # the reference's soft rows in bfloat16
            low = ref.decode(out["chips"], out["peak_idx"], out["peak_val"],
                             tab, soft_rows=soft, dtype=torch.bfloat16)
            DIAG.setdefault("soft_llr_err_bf16", []).append(
                soft_diff(low["scl_llr"], low["scl_ctr"], dec)[0])
            del low
        del dec["llr_rows"], dec["ctr_rows"]
    acc = {i: (n, c, "hard")
           for i, (n, c) in ref.hard_verdicts(dec, tab["sec"]).items()}
    rungs: list = []
    if waveform != "compat":
        B = batch.clips.shape[0]
        verdict = np.zeros(B, bool)
        verdict[list(acc)] = True
        any_hdr = dec["any_hdr"].cpu().numpy()
        evidence = any_hdr.copy()
        nohdr = ~verdict & ~evidence
        if nohdr.any():
            evidence |= nohdr & ref.near_start_mask(
                out["peak_idx"].cpu().numpy(), out["peak_val"].cpu().numpy(),
                tab["span"])
        pending = ~verdict & evidence
        if pending.any():
            scl_acc, rungs = ref.ladder(out["scl_llr"],
                                        out["scl_ctr"].cpu().numpy(),
                                        pending, list_size, tab)
            acc.update({i: (n, c, "scl") for i, (n, c) in scl_acc.items()})
    return dict(nums=nums, accepts=acc, rungs=rungs)


def compare(waveform: str, tab: dict, batches: list, stream, records: list,
            captures: dict, list_size: int | None, peaks: int, T: int
            ) -> dict:
    """Every number of the cell, over all calls of the window."""
    nums = {"verdict_mismatch": 0, "untrue_accept": 0, "rejected": 0,
            "wrong": 0, "sync_val_err": 0.0, "chips_rel_err": 0.0,
            "chips_rel_err_p50": 0.0, "decode_mismatch": 0}
    if waveform != "compat":
        nums.update(soft_llr_err=0.0, soft_ctr_mismatch=0, scl_mismatch=0)
    wants = {}
    for b, cap in captures.items():
        B = batches[b].clips.shape[0]
        if cap["out"]["peak_idx"].shape[0] != B:      # rows went missing
            for k, v in nums.items():
                if k not in VERDICT_NUMS:
                    nums[k] = float("inf") if isinstance(v, float) else v + B
            wants[b] = None
            continue
        r = reference_batch(waveform, tab, batches[b], cap["out"], list_size,
                            peaks)
        wants[b] = r["accepts"]
        for k, v in r["nums"].items():
            nums[k] = max(nums[k], v) if isinstance(v, float) else nums[k] + v
        if waveform != "compat":
            nums["scl_mismatch"] += scl_diff(cap["rungs"], r["rungs"])
        if batches[b].clips.is_cuda:
            torch.cuda.empty_cache()
    for b, verdicts, accepts in records:
        want = wants[b]
        nums["rejected"] += int((~verdicts).sum())
        if want is None:
            nums["verdict_mismatch"] += len(verdicts)
            nums["wrong"] += len(verdicts)
            continue
        got_ok = set(np.flatnonzero(verdicts).tolist())
        differ = (got_ok ^ set(want)) | {i for i in got_ok & set(want)
                                         if accepts.get(i) != want[i]}
        untrue = untrue_accepts(accepts, batches[b].starts, stream, T)
        nums["verdict_mismatch"] += len(differ)
        nums["untrue_accept"] += len(untrue)
        nums["wrong"] += len(differ | untrue)
    return nums


@torch.no_grad()
def compare_single(tab: dict, cuts: list, stream, records: list,
                   captures: dict, peaks: int, T: int) -> dict:
    """Every number of a single-clip cell.

    Every request is judged by what it says: each cut holds whole frames
    of the stream's session, so ``verdict_mismatch`` counts the rejected
    requests, and ``untrue_accept`` the accepts whose session nonce is not
    the stream's, whose counter's frame does not start at the reported
    position of the clip (within the +-2 sample offsets the scan tries),
    or whose band is not that counter's hop band.  ``sync_val_err`` and
    ``chips_rel_err`` hold the captured scan of every requested cut
    against the float64 reference: the sync from the cut alone, the chips
    (refined and raw direct profiles) at the program's own peaks;
    ``chips_rel_err_p50`` is the largest over the cuts of the median over
    the refined profile's candidates.
    """
    nums = {"verdict_mismatch": 0, "untrue_accept": 0, "wrong": 0,
            "sync_val_err": 0.0, "chips_rel_err": 0.0,
            "chips_rel_err_p50": 0.0}
    hop = tab["hop_table"].cpu().numpy()
    dev = tab["pn_table"].device
    for c, out in captures.items():
        x = torch.zeros(ref.pad_bucket(max(T, 2 * 1215 + 512)),
                        dtype=torch.float64, device=dev)
        x[:T] = torch.as_tensor(cuts[c].audio, device=dev)
        _, val = ref.sync_peaks(x[None], torch.tensor([T], device=dev), tab,
                                peaks)
        nums["sync_val_err"] = max(nums["sync_val_err"],
                                   sync_err(out["peak_val"], val[0]))
        chips = ref.single_chips(x, out["peak_idx"].to(dev), tab)
        got = out["chips_d"].to(dev)
        nums["chips_rel_err"] = max(nums["chips_rel_err"],
                                    chips_err(got, chips)[0])
        nums["chips_rel_err_p50"] = max(nums["chips_rel_err_p50"],
                                        chips_err(got[:, 0], chips[:, 0])[1])
    for c, verdicts, accepts in records:
        if not verdicts[0]:
            nums["verdict_mismatch"] += 1
            nums["wrong"] += 1
            continue
        nonce, ctr, _stage, pos, band = accepts[0]
        off = ctr * stream.span - int(cuts[c].start) - pos
        untrue = int(nonce != stream.nonce or abs(off) > 2
                     or ctr >= hop.size or hop[ctr] != band)
        nums["untrue_accept"] += untrue
        nums["wrong"] += untrue
    return nums
