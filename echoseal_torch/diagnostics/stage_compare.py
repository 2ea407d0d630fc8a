"""TX <-> RX stage-by-stage comparison, both waveform profiles.

Embeds a frame stream with pinned plaintexts (fixed session nonce and
payload padding), optionally pushes it through a channel impairment, then
walks the receive pipeline one stage at a time, scoring each stage
against the TX-side ground truth:

  sync      peak position error vs the true frame grid, peak score
  demod     per-segment chip agreement (preamble / header / payload),
            per regularisation profile
  header    decoded lo16 vs the true counter, margin
  llr       sign-agreement with the true codeword, mean |LLR| split by
            correct/wrong sign (the "is the soft information honest?" row)
  fec       hard-decision CRC pass; SCL(32) pass
  crypto    AEAD open + magic/ctr checks

Sync, header, LLR (the ``payload_llr`` kernel on the card) and FEC run on
``--device``; the LS demod is a host float32 product, as in the JAX
package.

Run:  python -m echoseal_torch.diagnostics.stage_compare \
          [--profile compat|v2] [--impair awgn:8|mp3|timescale:1.03] \
          [--frame N] [--seconds S] [--device cuda|cpu]

The first stage whose score collapses is where the pipeline (or the
channel) broke.  The JSON report goes to stdout; ``main`` also returns it.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def _impair(x: np.ndarray, spec: str | None, wm_rms: float, rng):
    from echoseal_torch.utils import channels

    if not spec:
        return x, "none"
    kind, _, arg = spec.partition(":")
    if kind == "awgn":
        snr = float(arg or 8.0)
        n = rng.standard_normal(x.size).astype(np.float32)
        return x + wm_rms * 10.0 ** (-snr / 20.0) * n, f"awgn wm-snr {snr} dB"
    if kind == "mp3":
        return channels.codec_sim(x, float(arg or 128.0))[: x.size], "mp3-sim"
    if kind == "timescale":
        f = float(arg or 1.03)
        return channels.time_scale(x, f), f"timescale x{f}"
    raise SystemExit(f"unknown impairment {spec!r}")


def _pinned_v2_frame(tx, sec, nonce: bytes, payloads: dict[int, bytes]):
    """A ``_make_frame`` for a v2 embedder that seals a fixed plaintext
    per counter and records each sealed payload in ``payloads``."""
    from scipy.signal import lfilter

    from echoseal_torch.core.params import FRAME_LEN, HDR_L, PRE_L
    from echoseal_torch.core.sequences import bits_to_bpsk, header_bits
    from echoseal_torch.ops import filters
    from echoseal_torch.ops.polar import encode_np

    S = tx.profile.oversample

    def make_frame():
        c = tx.frame_ctr
        band = tx._hop.band(c)
        payload = payloads.setdefault(
            c, sec.seal(b"ESAL" + c.to_bytes(4, "big") + nonce
                        + b"\x11" * 11))
        data_sy = bits_to_bpsk(encode_np(payload, tx._spec))
        hdr_sy = bits_to_bpsk(header_bits(c)) * tx._hdr_pn_sy
        pn = tx.sec.pn_bits(c, FRAME_LEN)[PRE_L + HDR_L:]
        spread = data_sy * bits_to_bpsk(pn)
        sym = np.concatenate([tx._preamble_sy, hdr_sy, spread])
        up = np.repeat(sym.astype(np.float64), S)
        b, a = filters.butter_coeffs(band[0], band[1], tx.p.fs)
        chips = lfilter(b, a, up)
        peak = float(np.max(np.abs(chips))) + 1e-12
        if peak > 3.0:
            chips = chips / peak
        return chips.astype(np.float32)
    return make_frame


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", choices=("compat", "v2"), default="v2")
    ap.add_argument("--impair", default=None,
                    help="awgn:SNRdB | mp3[:kbps] | timescale:FACTOR")
    ap.add_argument("--frame", type=int, default=1,
                    help="which frame of the stream to score against")
    ap.add_argument("--seconds", type=float, default=3.5)
    from echoseal_torch.diagnostics import device_arg, device_of

    device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from echoseal_torch.core.bandplan import hop_schedule
    from echoseal_torch.core.crypto import SecureChannel
    from echoseal_torch.core.device import resolve_device
    from echoseal_torch.core.params import FRAME_LEN, HDR_L, PRE_L
    from echoseal_torch.core.profiles import COMPAT, ROBUST, profile_spec
    from echoseal_torch.core.sequences import bits_to_bpsk, header_bits, mls63
    from echoseal_torch.ops import demod
    from echoseal_torch.ops.llr import payload_llr
    from echoseal_torch.ops.polar import encode_np, hard_decode_batch
    from echoseal_torch.ops.scl import scl_decode

    dev = resolve_device(device_of(args))

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    fs = 48_000
    key = b"\xaa" * 32
    sec = SecureChannel(key)
    hop = hop_schedule(key)
    profile = COMPAT if args.profile == "compat" else ROBUST
    spec = profile_spec(profile)
    span = profile.span
    rng = np.random.default_rng(7)
    report: dict = {"profile": profile.name}

    # ---------------- TX with pinned plaintexts ----------------------------
    ctr = args.frame
    nonce = b"STAGECMP"
    payloads: dict[int, bytes] = {}
    if args.profile == "compat":
        from echoseal_torch.models.embedder import WatermarkEmbedder

        tx = WatermarkEmbedder(key)
        tx._session_nonce = nonce

        def build_payload():
            c = tx.frame_ctr
            p = sec.seal(b"ESAL" + c.to_bytes(4, "big") + nonce
                         + b"\x11" * 11)
            payloads[c] = p
            return p

        tx._build_payload = build_payload
    else:
        from echoseal_torch.models.robust import RobustEmbedder

        tx = RobustEmbedder(key)
        tx._session_nonce = nonce
        tx._make_frame = _pinned_v2_frame(tx, sec, nonce, payloads)

    T = int(args.seconds * fs)
    wm = tx.process(np.zeros(T, np.float32))
    wm_rms = float(np.sqrt(np.mean(wm * wm)))
    clip, tag = _impair(wm, args.impair, wm_rms, rng)
    report["impairment"] = tag

    payload = payloads[ctr]
    true_bits = encode_np(payload, spec)
    band_idx = hop.index(ctr)
    lo, hi = hop.band(ctr)
    true_start = ctr * span
    report["truth"] = dict(frame=ctr, band=band_idx, start=true_start)

    # ---------------- stage 1: sync ---------------------------------------
    if args.profile == "compat":
        templates = demod.sync_templates(fs)
    else:
        from echoseal_torch.models.robust import robust_templates

        templates = robust_templates(fs, profile.oversample)
    Tpad = 1 << max(17, (clip.size + span - 1).bit_length())
    x = np.zeros(Tpad, np.float32)
    x[: clip.size] = clip
    corr = demod.normalized_xcorr(on_dev(x), on_dev(templates)).cpu().numpy()
    corr = corr[:, : clip.size - span]
    peak = int(np.argmax(corr[band_idx]))
    report["sync"] = dict(
        peak=peak, err_samples=peak - true_start,
        score=round(float(corr[band_idx, peak]), 4),
        best_other_band=round(float(np.max(
            np.delete(corr, band_idx, axis=0))), 4),
    )

    # ---------------- stage 2: demod --------------------------------------
    start = peak if abs(peak - true_start) <= 2 else true_start
    win = x[start : start + span].astype(np.float32)
    win = win / (np.sqrt(np.mean(win**2)) + 1e-30)
    if args.profile == "compat":
        mats = {f"direct lam={lam:g}": demod.demod_matrix_direct(lo, hi, fs,
                                                                  lam)
                for lam in demod.LAM_DIRECT_PROFILES}
    else:
        from echoseal_torch.models.robust import (
            LAM_PROFILES,
            robust_demod_matrix,
        )

        mats = {f"v2 lam={lam:g}": robust_demod_matrix(
            lo, hi, fs, profile.oversample, lam) for lam in LAM_PROFILES}

    pre_sy = bits_to_bpsk(mls63())
    hdr_pn_sy = bits_to_bpsk(sec.pn_bits(0, HDR_L))
    hdr_sy_true = bits_to_bpsk(header_bits(ctr)) * hdr_pn_sy
    pn_sy = bits_to_bpsk(sec.pn_bits(ctr, FRAME_LEN)[PRE_L + HDR_L:])
    data_sy = bits_to_bpsk(true_bits) * pn_sy

    report["demod"] = {}
    best_chips = None
    best_agree = -1.0
    for name, M in mats.items():
        chips = M.astype(np.float32) @ win
        seg = {}
        for seg_name, sl, truth in (
            ("preamble", slice(0, PRE_L), pre_sy),
            ("header", slice(PRE_L, PRE_L + HDR_L), hdr_sy_true),
            ("payload", slice(PRE_L + HDR_L, FRAME_LEN), data_sy),
        ):
            agree = float(np.mean(np.sign(chips[sl]) == np.sign(truth)))
            seg[seg_name] = round(agree, 4)
        report["demod"][name] = seg
        if seg["payload"] > best_agree:
            best_agree = seg["payload"]
            best_chips = chips

    # ---------------- stage 3: header -------------------------------------
    ok, lo16, score = (v.cpu().numpy() for v in demod.header_decode(
        on_dev(best_chips[None]), on_dev(hdr_pn_sy)))
    report["header"] = dict(ok=bool(ok[0]), lo16=int(lo16[0]),
                            true_lo16=ctr & 0xFFFF,
                            score=round(float(score[0]), 3))

    # ---------------- stage 4: llr ----------------------------------------
    llr_dev = payload_llr(on_dev(best_chips[None]), on_dev(pn_sy[None]))
    llr = llr_dev.cpu().numpy()[0]
    sign_ok = (llr > 0) == (true_bits > 0.5)
    report["llr"] = dict(
        sign_agreement=round(float(np.mean(sign_ok)), 4),
        mean_abs_correct=round(float(np.mean(np.abs(llr[sign_ok]))), 2),
        mean_abs_wrong=round(float(np.mean(np.abs(llr[~sign_ok])))
                             if (~sign_ok).any() else 0.0, 2),
        n_wrong=int((~sign_ok).sum()),
    )

    # ---------------- stage 5: fec ----------------------------------------
    info, crc_ok = (v.cpu().numpy() for v in hard_decode_batch(llr_dev, spec))
    scl = {k: v.cpu().numpy() for k, v in scl_decode(llr_dev, spec,
                                                      32).items()}
    scl_hit = False
    for li in np.flatnonzero(scl["crc_ok"][0]):
        bits = scl["info_bits"][0, li].astype(np.uint8)
        scl_hit |= np.packbits(bits).tobytes() == payload
    report["fec"] = dict(hard_crc=bool(crc_ok[0]), scl32=bool(scl_hit))

    # ---------------- stage 6: crypto -------------------------------------
    blob = np.packbits(info[0].astype(np.uint8)).tobytes()
    plain, layout = sec.open_any_layout(blob)
    report["crypto"] = dict(
        aead_ok=plain is not None,
        magic_ok=bool(plain and plain.startswith(b"ESAL")),
        ctr_ok=bool(plain and int.from_bytes(plain[4:8], "big") == ctr),
        layout=layout,
    )

    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
