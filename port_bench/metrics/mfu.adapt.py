"""Model FLOPs of the traced task (``flops.adapt_task_flops``) over the
traced window times the chip's bf16 peak, in %."""
from port_bench import peaks


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "adapt" or not tr or tr["busy_s"] <= 0:
        return None
    pk = peaks.peaks_for(rec["device_kind"])
    return 100.0 * tr["flops"] / (tr["window_s"] * pk["bf16_flops"])
