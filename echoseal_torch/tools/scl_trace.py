"""Where a row's time goes inside the SCL kernel, op by op, on one card.

    python3 -m echoseal_torch.tools.scl_trace [--source CU] \
        [SPEC:ROWS:L[:BLOCK_SEG] ...]

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
their own forks (``node_share``; ``node_cycles_per_fork``, their cycles
over the forks they make at this L; ``node_phases``, their cycles split
into the rank pass, the forks, the partial sums with the permutation and
the closing barrier, where the source has the anchors).  ``--source``
traces another copy of the kernel source (a parent commit's, say) instead
of this checkout's.
Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

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


# a serving node's phases, stamped before these lines: its rank pass done,
# its forks done (in registers, or through memory), its partial sums and
# permutation done
_NODE = "if (row == 0 && threadIdx.x == 0) g_node[3 * k + {j}] = clock64();\n"
NODE_ANCHORS = (
    ("          // the parity of buffer b's hard decisions (SPC)\n", 0),
    ("              if (live) {\n                s_metric[p] = met;\n", 1),
    ("            const uint32_t* stf = s_st + nc * L;\n", 1),
    ("          if (t0 < need) {                 // the node's one "
     "permutation\n", 2))
NODE_PHASES = ("rank", "forks", "finish")


def traced_source(src: str) -> str:
    """``src`` with the stamps and a reader ``scl_trace_read``; where the
    serving node's phase anchors are all found once, also their stamps and
    ``scl_trace_node`` (another source, without them, traces the ops
    alone)."""
    for anchor, stamp, after in ANCHORS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"scl_trace: anchor {anchor.strip()!r} not "
                               "once in scl_decode.cu")
        src = src.replace(anchor, anchor + stamp if after else stamp + anchor)
    decl = "__device__ long long g_stamp[8192];\n"
    tail = ('\nextern "C" int scl_trace_read(long long* out, int n) {\n'
            "  return static_cast<int>(cudaMemcpyFromSymbol(out, "
            "g_stamp, n * 8));\n}\n")
    if all(src.count(a) == 1 for a, _ in NODE_ANCHORS):
        for anchor, j in NODE_ANCHORS:
            src = src.replace(anchor, _NODE.format(j=j) + anchor)
        decl += "__device__ long long g_node[3 * 8192];\n"
        tail += ('extern "C" int scl_trace_node(long long* out, int n) {\n'
                 "  return static_cast<int>(cudaMemcpyFromSymbol(out, "
                 "g_node, n * 8));\n}\n")
    src = src.replace("namespace {\n", "namespace {\n" + decl, 1)
    return src + tail


def _load(source: Path) -> tuple[ctypes.CDLL, tuple]:
    out_dir = build.BUILD_DIR / "trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "scl_trace.cu"
    src.write_text(traced_source(source.read_text()))
    lib = out_dir / "libscl_trace.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.scl_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if hasattr(dll, "scl_trace_node"):
        dll.scl_trace_node.argtypes = [ctypes.c_void_p, ctypes.c_int]
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
    node = np.isin(code, (scl.OP_RATE1, scl.OP_SPC))
    nodes = cycles[node].sum()
    out["node_share"] = float(nodes / max(out["row_cycles"], 1))
    node_forks = scl.schedule_forks(ops[node], spec.N, L)
    out["node_forks"] = node_forks
    out["node_cycles_per_fork"] = float(nodes / node_forks) \
        if node_forks else None
    if block_seg is not None and hasattr(dll, "scl_trace_node"):
        marks = np.zeros(3 * ops.size, dtype=np.int64)
        if dll.scl_trace_node(marks.ctypes.data, marks.size) != 0:
            raise RuntimeError("scl_trace: reading the node stamps failed")
        at = np.concatenate((stamps[:-1, None], marks.reshape(-1, 3),
                             stamps[1:, None]), axis=1)[node]
        out["node_phases"] = {
            ph: {"median_cycles": int(np.median(d)), "cycles": int(d.sum())}
            for ph, d in zip(NODE_PHASES + ("sync",), np.diff(at, axis=1).T)}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=build.CSRC / "scl_decode.cu")
    ap.add_argument("shapes", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scl_trace: needs a CUDA card")
    dll, kernel = _load(args.source)
    for shape in (args.shapes or SHAPES):
        name, rows, L, *seg = shape.split(":")
        print(json.dumps(trace(dll, kernel, name, int(rows), int(L),
                               int(seg[0]) if seg else None)), flush=True)


if __name__ == "__main__":
    main()
