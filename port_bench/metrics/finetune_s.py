"""Mean ``train_seconds`` of the window's untraced tasks: the program's
own span around the fused fine-tune loop and its one fetch."""


def read(rec):
    xs = [t["train_s"] for t in rec.get("tasks", ()) if not t["traced"]]
    return sum(xs) / len(xs) if xs else None
