"""Mean host ms per request of some of the program's ``Timer`` spans,
over the traced run's window (the registry is emptied when it starts)."""


def per_request_ms(ctx, names):
    spans, n = ctx.get("spans"), ctx.get("requests")
    if not spans or not n or not any(k in spans for k in names):
        return None
    return 1e3 * sum(sum(spans.get(k, [])) for k in names) / n
