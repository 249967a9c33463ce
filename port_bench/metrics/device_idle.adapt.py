"""Share of the traced window in which no operation ran on the device."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "adapt" or not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
