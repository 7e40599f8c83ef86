"""The control of the comparison that decides `correct`: a run of a cell
with the program's float32 matrix products in TF32, the precision below the
float32 (TF32 off) that the configurations state. Its `correct` has to come
out false.

The program turns TF32 off when it is imported; the control turns it back
on. The program's products are small batched ones (4x4 poses, 3x12 and
12x12 blocks) and matrix-vector products, which cuBLAS runs on kernels that
never use TF32 whatever the switch says (on the H100 the switch alone left
every compared number where it was), so the control also rounds every
float32 operand of `@`, `matmul`, `bmm` and `einsum` to TF32's 10-bit
mantissa, as a TF32 tensor-core product does with its inputs.

    python3 -m benchmark.control --workload <cell> --seed <n> --seconds <s>

Arguments and output as `benchmark.run`; the benchmark's own runs never run
it.
"""

from __future__ import annotations

import sys
from contextlib import contextmanager

from benchmark import run


def to_tf32(x):
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even),
    kept in float32; other dtypes unchanged."""
    import torch

    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    i = (i + (0x0FFF + ((i >> 13) & 1))) & ~0x1FFF
    return i.view(torch.float32).view(x.shape)


@contextmanager
def tf32_products():
    """The program's float32 products in TF32 while the block runs."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    originals = {"matmul": torch.matmul, "bmm": torch.bmm, "einsum": torch.einsum,
                 "__matmul__": torch.Tensor.__matmul__, "__rmatmul__": torch.Tensor.__rmatmul__,
                 "Tensor.matmul": torch.Tensor.matmul}

    def product(fn):
        return lambda a, b, *args, **kw: fn(to_tf32(a), to_tf32(b), *args, **kw)

    def einsum(eq, *ops):
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = tuple(ops[0])
        return originals["einsum"](eq, *(to_tf32(o) for o in ops))

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    torch.matmul, torch.bmm, torch.einsum = (product(originals["matmul"]),
                                             product(originals["bmm"]), einsum)
    torch.Tensor.__matmul__ = product(originals["__matmul__"])
    torch.Tensor.__rmatmul__ = product(originals["__rmatmul__"])
    torch.Tensor.matmul = product(originals["Tensor.matmul"])
    try:
        yield
    finally:
        torch.matmul, torch.bmm, torch.einsum = (originals["matmul"], originals["bmm"],
                                                 originals["einsum"])
        torch.Tensor.__matmul__ = originals["__matmul__"]
        torch.Tensor.__rmatmul__ = originals["__rmatmul__"]
        torch.Tensor.matmul = originals["Tensor.matmul"]
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


if __name__ == "__main__":
    sys.exit(run.main(control=True))
