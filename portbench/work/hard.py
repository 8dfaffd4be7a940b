"""What the dense hard raster needs, whatever the kernel's design (a frozen
copy of `chip_smoke.hard_kernel_bytes`): its four [B, S, S] outputs written
once (part labels, silhouette, depth, shade: 16 B a pixel), and each face's
13 float32 edge and depth coefficients and its `ok` byte a batch row, and
each face's class, read once. The bound is these bytes at HBM rate: the
edge tests of the faces over the pixels they cover take less time at the
float32 rate."""

from __future__ import annotations

from portbench import work


def hard_bytes(B: int, F: int, S: int) -> int:
    """Least traffic of one launch on B images of S² pixels and F faces."""
    return B * S * S * 16 + B * F * (13 * 4 + 1) + F * 4


def bound_ms(B: int, F: int, S: int) -> float:
    """The least time of one launch, ms."""
    return hard_bytes(B, F, S) / work.HBM_BYTES_PER_S * 1e3
