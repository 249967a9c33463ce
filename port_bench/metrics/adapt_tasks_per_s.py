"""Tasks adapted (probe, selection, fine-tune, deltas on the device) over
the window, from its start to the last task's completion (host clock)."""


def read(rec):
    if rec["kind"] != "adapt" or not rec["tasks"]:
        return None
    return len(rec["tasks"]) / rec["tasks"][-1]["t_done"]
