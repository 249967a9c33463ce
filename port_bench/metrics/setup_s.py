"""Set-up: process start to the first timed operation (host clock)."""


def read(rec):
    return rec["setup_s"]
