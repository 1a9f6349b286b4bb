"""Published peaks of the chips the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates without sparsity, at the full 700 W power
limit).  A roofline share or an MFU is stated against these."""
from __future__ import annotations

from typing import Optional

PEAKS = {
    "H100": {"bf16_flops": 989e12, "f32_flops": 67e12,
             "hbm_bytes_per_s": 3.35e12},
}


def peaks_of(device_name: str) -> Optional[dict]:
    """The peak table of a device by its name, ``None`` for one that is
    not in the table (a CPU): no roofline or MFU is read there."""
    for key, table in PEAKS.items():
        if key in device_name:
            return table
    return None
