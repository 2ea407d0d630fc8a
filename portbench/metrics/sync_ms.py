"""Device ms of the sync stage per batch: the CUDA-event marks
``sync_xcorr`` + ``sync_nms`` of ``run_device(marks=)``, mean of the
marked passes."""


def read(ctx):
    m = ctx.get("marked")
    if not m:
        return None
    xs = [s["sync_xcorr"] + s["sync_nms"] for s in m["stages"]
          if "sync_xcorr" in s and "sync_nms" in s]
    return sum(xs) / len(xs) if xs else None
