"""Developer diagnostics, the port's copies of ``echoseal_tpu.diagnostics``.

Each module runs as ``python -m echoseal_torch.diagnostics.<name>``; those
that touch a tensor take ``--device cuda|cpu`` (default ``cuda``: an
NVIDIA GPU must be present), as the port's ``rx_app`` does:

* ``frame_check``       -- synthesize a frame per band, run the
  single-clip scan stage on it, report chip BER / preamble / header.
* ``polar_roundtrip``   -- AWGN BLER sweep of the SCL decoder for both
  info-set conventions.
* ``pn_check``          -- PN keystream determinism + hop-schedule audit
  (host only).
* ``frozen_check``      -- frozen-set / info-set audit for both profiles:
  convention membership + encode -> hard decode round trip.
* ``stage_compare``     -- TX <-> RX stage-by-stage scores (sync, demod,
  header, LLR, FEC, crypto) on a pinned stream, optionally impaired.
* ``capability_report`` -- accept matrix of both single-clip tiers across
  hosts x impairments.
* ``design_pqmf``       -- regenerates the filterbank window pair of
  ``data/pqmf512.py`` (host only).
"""
import argparse


def device_arg(ap: argparse.ArgumentParser) -> None:
    """Add ``--device cuda|cpu`` (default cuda) to a diagnostic's parser."""
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where tensors live (default cuda: an NVIDIA GPU "
                         "must be present)")


def device_of(args: argparse.Namespace) -> str | None:
    """The port's device rule: ``cuda`` -> None (raises without a card)."""
    return None if args.device == "cuda" else args.device
