"""The H100's facts that the kernels' plans size their launches by."""

from __future__ import annotations

MAX_SMEM = 232448  # 227 KB: the dynamic shared memory one block can have
SM_SMEM, BLOCK_RESERVED = 233472, 1024  # shared memory per SM (228 KB), and reserved per block
H100_SMS = 132  # the planning default off the card; a launch plans with its device's count


def align16(n: int) -> int:
    return (n + 15) & ~15
