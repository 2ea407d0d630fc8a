"""Data-parallel scale-out: the verify pipeline split over ranks.

The algorithm is embarrassingly parallel over clips -- no stream talks to
another -- so scale-out is pure data parallelism on one ``streams`` axis:
clips, lengths and outputs are split over the ranks of a
``torch.distributed`` process group, one process per device (``nccl`` on
CUDA cards, ``gloo`` on the CPU), and the per-key tables are replicated
because every rank builds its own verifier.  One ``all_reduce`` sums the
global CRC-pass count, the collective that crosses the interconnect on
every call.

Each ``shard_*`` returns ``fn(global batch)``.  Rank r runs rows
``[r*B/W, (r+1)*B/W)`` of the batch on its own device; every batched
output is then all-gathered in rank-major row order, so each rank holds the
global result, ready for the host finish (``finish_host``,
``_finish_ladder``) exactly as an unsplit run's.  ``B % W != 0`` raises
``ValueError``.  Every rank must make the same calls in the same order:
each call is a collective.
"""
from __future__ import annotations

import os
import typing

import torch
import torch.distributed as dist

from echoseal_torch.models import robust
from echoseal_torch.models.embedder import synthesize_frames_device
from echoseal_torch.models.pipeline import RobustBatchVerifier

STREAM_AXIS = "streams"

# the device type each backend's collectives run on
_BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


class StreamsMesh(typing.NamedTuple):
    """One rank's view of the 1-D ``streams`` axis."""
    group: dist.ProcessGroup | None   # None: the default group
    rank: int
    world_size: int
    device: torch.device              # this rank's device


def streams_mesh(group: dist.ProcessGroup | None = None,
                 device: str | torch.device | None = None) -> StreamsMesh:
    """This rank's mesh over ``group`` (default: the default group).

    ``device=None`` means this process's card and needs CUDA, under the
    port's device rule: ``cuda:<local rank>`` where a launcher sets
    ``LOCAL_RANK`` (``torchrun``), else the current CUDA device, which
    ``torch.cuda.set_device`` sets.  The group's backend must then be
    ``nccl``.
    ``device="cpu"`` goes with ``gloo``.  The process group must already be
    initialised (``dist.init_process_group``).
    """
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' with a gloo group")
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local is not None
                              else torch.cuda.current_device())
    device = torch.device(device)
    backend = str(dist.get_backend(group))
    want = _BACKEND_DEVICE.get(backend)
    if want is not None and device.type != want:
        raise ValueError(f"a {backend} group runs on {want} tensors, "
                         f"not on {device}")
    return StreamsMesh(group, rank, world, device)


def _rows(mesh: StreamsMesh, a, dtype: torch.dtype | None = None
          ) -> torch.Tensor:
    """This rank's rows of the global batch ``a``, on its device."""
    n = a.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"batch of {n} rows does not split over "
                         f"{mesh.world_size} ranks")
    per = n // mesh.world_size
    part = a[mesh.rank * per:(mesh.rank + 1) * per]
    return torch.as_tensor(part, dtype=dtype, device=mesh.device)


def _replicated(mesh: StreamsMesh, a, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype, device=mesh.device)


def _gather(mesh: StreamsMesh, t: torch.Tensor) -> torch.Tensor:
    """All-gather one rank's rows in rank order (bools travel as uint8)."""
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def _gather_batched(mesh: StreamsMesh, out: dict, n_local: int) -> dict:
    """Gather every entry with the local batch as its leading axis."""
    return {k: (_gather(mesh, v)
                if v.ndim >= 1 and v.shape[0] == n_local else v)
            for k, v in out.items()}


def _check_device(verifier, mesh: StreamsMesh) -> None:
    dev = torch.device(verifier.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev != mesh.device:
        raise ValueError(f"the verifier is on {dev}, this rank's device is "
                         f"{mesh.device}")


def _sharded_stage(verifier, mesh: StreamsMesh):
    _check_device(verifier, mesh)

    def run(clips, n_valid) -> dict[str, torch.Tensor]:
        x = _rows(mesh, clips, torch.float32)
        out = verifier.run_device(x, _rows(mesh, n_valid, torch.int32))
        count = out["crc_ok"].sum(dtype=torch.int32)
        dist.all_reduce(count, group=mesh.group)    # the JAX psum
        out = _gather_batched(mesh, out, x.shape[0])
        out["n_crc_ok"] = count
        return out

    return run


def shard_verify(verifier, mesh: StreamsMesh):
    """``fn(clips (B, T), n_valid (B,)) -> dict``: the compat stage split
    over the ranks.

    ``verifier`` is this rank's ``BatchVerifier`` on ``mesh.device``.  The
    dict holds every output of ``run_device`` for the whole batch, so
    ``finish_host`` (which may open a clip's later CRC-passing candidates)
    runs on it unchanged, plus ``n_crc_ok``: the global count of
    CRC-passing candidates, a 0-d int32 tensor summed over the ranks.
    """
    return _sharded_stage(verifier, mesh)


def shard_verify_v2(verifier, mesh: StreamsMesh):
    """The v2 stage of a ``RobustBatchVerifier`` split the same way.

    The host ladder (``_finish_ladder``: futility gate, staged SCL on the
    exported soft rows, extended counters) runs unchanged on the gathered
    outputs, whose every per-clip row is on this rank's device.
    """
    if not isinstance(verifier, RobustBatchVerifier):
        raise TypeError("shard_verify_v2 needs a RobustBatchVerifier")
    return _sharded_stage(verifier, mesh)


def shard_tx(mesh: StreamsMesh):
    """Batched TX split over the ranks:
    ``fn(info_bits, hdr_bits, pn_bits, hdr_pn_sy, pre_sy, band_idx, t_fwd)
    -> (B, FRAME_LEN)`` frames.

    The per-frame inputs (the first three and ``band_idx``) are split; the
    header PN, the preamble and the forward models ``t_fwd`` are
    replicated.  Arguments as for ``synthesize_frames_device``.
    """
    def run(info_bits, hdr_bits, pn_bits, hdr_pn_sy, pre_sy, band_idx,
            t_fwd) -> torch.Tensor:
        frames = synthesize_frames_device(
            _rows(mesh, info_bits), _rows(mesh, hdr_bits),
            _rows(mesh, pn_bits),
            _replicated(mesh, hdr_pn_sy, torch.float32),
            _replicated(mesh, pre_sy, torch.float32),
            _rows(mesh, band_idx),
            _replicated(mesh, t_fwd, torch.float32))
        return _gather(mesh, frames)

    return run


def shard_scan_v2(verifier, mesh: StreamsMesh):
    """The +-5 % scaled-template sync scan split over the ranks.

    ``fn(clips (B, T), n_valid (B,)) -> (B, rows)`` scores, the same as
    ``robust._scale_scan_batch`` on the whole batch; every rank scans with
    its verifier's scaled template bank, designed there at first use.
    """
    _check_device(verifier, mesh)
    bank = verifier._device_scan_bank()

    def run(clips, n_valid) -> torch.Tensor:
        return _gather(mesh, robust._scale_scan_batch(
            _rows(mesh, clips, torch.float32),
            _rows(mesh, n_valid, torch.int32), bank))

    return run


def shard_resample_v2(verifier, mesh: StreamsMesh, t_in: int):
    """The recovery stage's device resample split over the ranks.

    ``fn(clips (B, t_in), den) -> (y (B, cols), n_out)``: ``den`` is a
    denominator on the verifier's ``RETRY_UP`` lattice, as in
    ``_retry_scaled``; ``y`` is zero past ``n_out``.  The resampler family
    (``verifier._device_resampler(t_in)``) and its tap plans live on every
    rank.
    """
    _check_device(verifier, mesh)
    rs = verifier._device_resampler(t_in)

    def run(clips, den: int) -> tuple[torch.Tensor, int]:
        y, n_out = rs(_rows(mesh, clips, torch.float32), int(den))
        return _gather(mesh, y), n_out

    return run
