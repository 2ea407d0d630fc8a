"""Where a row's time goes inside the SCL kernel, op by op, on one card.

    python3 -m echoseal_torch.tools.scl_trace [SPEC:ROWS:L[:BLOCK_SEG] ...]

Builds a copy of ``csrc/scl_decode.cu`` in which the first thread of the
first block stamps ``clock64()`` as its first row starts each node op and
its final lists, runs one decode at each shape (default: ``chip_smoke.py``
phase 3c's ``SCL_SHAPES``) on random LLRs, and prints one JSON line per
shape: per op code the count, the median and the summed SM cycles; the
row's total cycles; the forks' share of them; and the stamped kernel's
CUDA-event ms (the stamps add one store per op).  Row 0 runs beside the
other rows of its launch, so its cycles include their contention.  SPEC is
``compat`` or ``v2``; a fourth field runs the serving decoder at that
``block_seg`` (``serving_schedule``), whose rate-1 and SPC node ops hold
their own forks (``node_share``).  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from echoseal_torch.core.profiles import ROBUST, profile_spec
from echoseal_torch.ops import build, polar, scl

SHAPES = ("compat:128:256", "compat:32:256", "v2:32:32", "v2:1024:8",
          "v2:321:8", "v2:107:32", "compat:32:512")
NAMES = ("f", "g", "rate0", "leaf", "rep", "comb", "rate1", "spc")
# (a line of the kernel's code, the stamp, whether it goes after the line)
_STAMP = "if (row == 0 && threadIdx.x == 0) g_stamp[{k}] = clock64();\n"
ANCHORS = (("      const int op = op_next;\n", _STAMP.format(k="k"), True),
           ("    const int P2 = pow2_at_least(L);\n", _STAMP.format(k="n_ops"),
            False))


def traced_source(src: str) -> str:
    """``src`` with the stamps and a reader ``scl_trace_read``."""
    for anchor, stamp, after in ANCHORS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"scl_trace: anchor {anchor.strip()!r} not "
                               "once in scl_decode.cu")
        src = src.replace(anchor, anchor + stamp if after else stamp + anchor)
    src = src.replace("namespace {\n",
                      "namespace {\n__device__ long long g_stamp[8192];\n", 1)
    return src + ('\nextern "C" int scl_trace_read(long long* out, int n) {\n'
                  "  return static_cast<int>(cudaMemcpyFromSymbol(out, "
                  "g_stamp, n * 8));\n}\n")


def _load() -> tuple[ctypes.CDLL, tuple]:
    out_dir = build.BUILD_DIR / "trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "scl_trace.cu"
    src.write_text(traced_source((build.CSRC / "scl_decode.cu").read_text()))
    lib = out_dir / "libscl_trace.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.scl_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return dll, scl.bind(dll)


def trace(dll, kernel: tuple, name: str, rows: int, L: int,
          block_seg: int | None = None) -> dict:
    """Stamp one decode of ``rows`` random rows of spec ``name`` at list
    size ``L`` through the wrapper (the serving one at ``block_seg`` if
    given), run on the traced build ``kernel``."""
    spec = polar.polar_spec() if name == "compat" else profile_spec(ROBUST)
    rng = np.random.default_rng(rows * 1024 + L)
    x = torch.from_numpy(np.clip(4.0 * rng.standard_normal(
        (rows, spec.N)), -16, 16).astype(np.float32)).cuda()
    if block_seg is None:
        def decode():
            scl.scl_decode_kernel(x, spec, L, kernel=kernel)
        ops = scl.node_schedule(spec)
    else:
        def decode():
            scl.scl_decode_serving_kernel(x, spec, L, block_seg,
                                          kernel=kernel)
        ops = scl.serving_schedule(spec, block_seg)
    decode()                                                 # warm-up
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    decode()
    b.record()
    torch.cuda.synchronize()
    stamps = np.zeros(ops.size + 1, dtype=np.int64)
    if dll.scl_trace_read(stamps.ctypes.data, stamps.size) != 0:
        raise RuntimeError("scl_trace: reading the stamps failed")
    cycles = np.diff(stamps)
    code = ops & 15
    out = {"spec": name, "rows": rows, "L": L, "block_seg": block_seg,
           "ms": a.elapsed_time(b),
           "row_cycles": int(stamps[-1] - stamps[0]), "ops": {}}
    for c, op_name in enumerate(NAMES):
        sel = code == c
        if sel.any():
            out["ops"][op_name] = {"n": int(sel.sum()),
                                "median_cycles": int(np.median(cycles[sel])),
                                "cycles": int(cycles[sel].sum())}
    forks = cycles[np.isin(code, (scl.OP_LEAF, scl.OP_REP))].sum()
    out["fork_share"] = float(forks / max(out["row_cycles"], 1))
    nodes = cycles[np.isin(code, (scl.OP_RATE1, scl.OP_SPC))].sum()
    out["node_share"] = float(nodes / max(out["row_cycles"], 1))
    return out


def main(argv=None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("scl_trace: needs a CUDA card")
    dll, kernel = _load()
    for shape in (argv if argv else SHAPES):
        name, rows, L, *seg = shape.split(":")
        print(json.dumps(trace(dll, kernel, name, int(rows), int(L),
                               int(seg[0]) if seg else None)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
