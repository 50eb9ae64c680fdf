"""wavefront_ms_per_step: the synchronised p.intra_wavefront_pass seconds
of the window's second part over the intra wavefront steps
(gpu.intra_pass.WAVEFRONT) taken there."""


def read(rec):
    tr = rec.get("trace") or {}
    steps = tr.get("wavefront_steps", 0)
    secs = sum(s for n, s in tr.get("spans", ())
               if n == "p.intra_wavefront_pass")
    return 1e3 * secs / steps if steps else None
