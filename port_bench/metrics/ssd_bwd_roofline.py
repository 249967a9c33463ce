"""Kernel 5b's share of its roofline: the traced backward calls times the
least time one call could take at the cell's call shape (``work.ssd_work``
at pad rows x seq tokens, bf16 inputs, bound by the bf16 tensor peak or
HBM), over the device time of its two kernels (``ssd_bwd_kernel`` and
``reduce_groups``).  The shape is known only through the count: where the
traced calls are not the count the model implies at that shape (one call
a feature batch and layer), the launches do not all share it and the
metric is left out."""
from port_bench import peaks, work


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "adapt" or not tr:
        return None
    calls = sum(n for k, n in tr["device_count_by_name"].items()
                if "ssd_bwd_kernel" in k)
    busy = sum(s for k, s in tr["device_s_by_name"].items()
               if "ssd_bwd_kernel" in k or "reduce_groups" in k)
    if not calls or busy <= 0 or calls != tr.get("ssd_bwd_expected"):
        return None
    sz, mix = rec["sizes"], rec["mix"]
    pk = peaks.peaks_for(rec["device_kind"])
    nbytes, ops = work.ssd_work(mix["pad"], mix["seq"], sz.n_ssm_heads,
                                sz.ssm_head_dim, sz.ssm_state, 2, True)
    bound = work.bound_seconds(nbytes, ops, pk["bf16_flops"],
                               pk["hbm_bytes"])
    return 100.0 * calls * bound / busy
