"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet
for the H100 SXM: dense rates without sparsity, at its 700 W limit)."""
from __future__ import annotations

H100_SXM = {
    "bf16_flops": 989e12,   # and fp16
    "fp8_flops": 1979e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,    # outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
    "power_limit_w": 700.0,
}

# device name (torch.cuda.get_device_name) -> peaks
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks_of(kind: str) -> dict:
    """The peaks of the card named ``kind``; raises for a card the table
    does not hold, rather than reading a share against another card's."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}: add them to "
                       f"portbench/harness/peaks.py")
    return PEAKS[kind]
