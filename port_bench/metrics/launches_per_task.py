"""Kernel-launch API calls in the traced window over the tasks it holds."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "adapt" or not tr or not tr.get("tasks"):
        return None
    return tr["launches"] / tr["tasks"]
