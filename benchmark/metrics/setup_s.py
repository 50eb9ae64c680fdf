"""setup_s: seconds from process start to the window's start (imports,
the kernels' libraries, the source, the IDR and the set-up P pictures)."""


def read(rec):
    return rec["setup_s"]
