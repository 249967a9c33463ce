"""Peak rates of the chips the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives: NVIDIA's data sheet for the H100
SXM part, dense rates without sparsity, at its 700 W limit."""
from __future__ import annotations

from typing import Dict

H100 = {"bf16_flops": 989e12, "tf32_flops": 495e12, "f32_flops": 67e12,
        "hbm_bytes": 3.35e12}

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": H100,
    "NVIDIA H100": H100,
}


def peaks_for(kind: str) -> Dict[str, float]:
    """The table's row for a device name; a name it lacks raises, so no
    share is ever taken of a guessed peak."""
    for name, row in PEAKS.items():
        if kind == name or kind.startswith(name):
            return row
    raise KeyError(f"no peak rates for device {kind!r}")
