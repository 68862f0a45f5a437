"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set below
700 W runs slower under load; the run reports its ``power.limit``
beside every share of these peaks."""

BF16_FLOPS = 989e12        # dense bf16 tensor-core operations per second
HBM_BYTES = 3.35e12        # HBM3 bytes per second
HBM_CAPACITY = 80e9        # bytes of device memory


def bound_s(flops: float, nbytes: float) -> float:
    """The least time a call of ``flops`` operations moving ``nbytes``
    can take on the card: the larger of its compute and memory bounds."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
