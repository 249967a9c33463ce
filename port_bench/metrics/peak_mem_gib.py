"""The run's highest torch.cuda.max_memory_allocated(), in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec["peak_bytes"] else None
