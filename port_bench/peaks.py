"""The device peaks the shares are taken against, by the name that
``torch.cuda.get_device_name()`` gives: NVIDIA's data sheet for the H100
SXM (dense rates, no sparsity), at the full 700 W power limit. A device
not in the table has no peaks, and the shares of them are left out."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,      # dense bf16 / fp16 tensor cores
        "f32_flops": 67e12,        # float32 outside the tensor cores
        "memory_bytes_per_s": 3.35e12,
    },
}


def for_device(name: str) -> dict | None:
    return PEAKS.get(name)
