"""peak_mem_gib: torch.cuda.max_memory_allocated() over the run, in GiB."""


def read(rec):
    b = rec.get("peak_bytes")
    return None if b is None else b / 2 ** 30
