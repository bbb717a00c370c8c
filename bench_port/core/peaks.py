"""Published peaks of the card the benchmark runs on (NVIDIA's data sheet
for the H100 SXM, dense rates without sparsity, at the full 700 W). A
roofline share or an MFU is stated against these, with the card's power
limit beside it."""
from __future__ import annotations

# the name torch.cuda.get_device_name() gives -> peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp32_flops": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str) -> dict:
    """The peaks of the card `device_name` names. Raises for a card that is
    not in the table: a share of an unknown peak is not a number."""
    if device_name not in PEAKS:
        raise ValueError(f"no published peaks for {device_name!r}")
    return dict(PEAKS[device_name])
