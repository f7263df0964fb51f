"""numpy-int64 oracle for the EFU element-wise ops."""
from __future__ import annotations

import numpy as np


def eltwise_ref(op: str, basis: tuple[int, ...], *arrays: np.ndarray) -> np.ndarray:
    q = np.array(basis, dtype=np.int64)[:, None]
    a = [x.astype(np.int64) for x in arrays]
    if op == "mul":
        r = a[0] * a[1] % q
    elif op == "add":
        r = (a[0] + a[1]) % q
    elif op == "sub":
        r = (a[0] - a[1]) % q
    elif op == "mac":
        r = (a[0] * a[1] % q + a[2] * a[3] % q) % q
    elif op == "muladd":
        r = (a[0] * a[1] % q + a[2]) % q
    else:
        raise ValueError(op)
    return r.astype(np.uint32)
