"""host_emit_ms: the mean synchronised p.host_emit span (the native
emitter's walk and CABAC of one P picture) in the window's second part."""


def read(rec):
    tr = rec.get("trace")
    spans = [s for n, s in (tr or {}).get("spans", ()) if n == "p.host_emit"]
    return 1e3 * sum(spans) / len(spans) if spans else None
