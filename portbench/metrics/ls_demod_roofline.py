"""The v2 LS-demod GEMM's share of its roofline: the least time of its
float32 operations and bytes at the H100's published peaks, over the
device ms of the ``demod`` mark (which also holds the window slicing and
normalisation, so the share is a lower bound), in %."""
from portbench import peaks


def read(ctx):
    m = ctx.get("marked")
    if not m:
        return None
    xs = [s["demod"] for s in m["stages"] if "demod" in s]
    if not xs:
        return None
    r = ctx["runner"]
    flops, nbytes = peaks.ls_demod_work(
        r.batches[0].clips.shape[0], r.verifier.peaks, r.verifier.span)
    return peaks.roofline_pct(flops, nbytes, 1e-3 * sum(xs) / len(xs))
