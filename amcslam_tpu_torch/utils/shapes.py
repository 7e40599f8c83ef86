"""Shape-bucketing policy (port of amcslam_tpu/utils/shapes.py).

PyTorch runs eagerly and needs no re-trace buckets; the port keeps the
function so the host-side table functions emit the same padded shapes as the
reference, and arrays compare one for one.
"""


def bucket_pow2(n: int, minimum: int = 16, factor: int = 2) -> int:
    """Smallest ``minimum * factor**k >= n`` (returns ``minimum`` for n<=it)."""
    b = minimum
    while b < n:
        b *= factor
    return b
