"""Mean ``fisher_seconds`` of the window's untraced tasks: the program's
own span around the probe (tap gradients, Eq. 2 on the device, the one
fetch of the scores)."""


def read(rec):
    xs = [t["fisher_s"] for t in rec.get("tasks", ()) if not t["traced"]]
    return sum(xs) / len(xs) if xs else None
