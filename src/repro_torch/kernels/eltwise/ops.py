"""EFU element-wise ops: the CUDA kernel, its plain torch version, the wrapper.

    mul    : a ⊙ b              add/sub : a ± b
    mac    : a ⊙ b + c ⊙ d      muladd  : a ⊙ b + c        (all mod q_limb)

Operands are equal-shape (…, ℓ, N) int32 residue tensors; the per-limb primes
come device-resident from :mod:`repro_torch.core.const_cache`.
"""
from __future__ import annotations

import torch

from repro_torch.core import const_cache
from repro_torch.kernels import config, native

OPS = ("mul", "add", "sub", "mac", "muladd")
ARITY = {"mul": 2, "add": 2, "sub": 2, "mac": 4, "muladd": 3}


def eltwise(op: str, basis: tuple[int, ...], *arrays: torch.Tensor) -> torch.Tensor:
    """The EFU op over ``basis``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if op not in OPS or len(arrays) != ARITY[op]:
        raise ValueError(f"eltwise {op!r} with {len(arrays)} operands")
    kernel = native.on_cuda(*arrays)
    q = const_cache.device_q(tuple(basis), arrays[0].device)
    if kernel:
        return eltwise_cuda(op, q, *(a.contiguous() for a in arrays))
    return eltwise_plain(op, q, *arrays)


def eltwise_plain(op: str, q: torch.Tensor, *arrays: torch.Tensor) -> torch.Tensor:
    """Plain torch version: int64 products (< 2⁶⁰) and exact ``%``.

    q: (ℓ, 1) int64 primes broadcasting against the (…, ℓ, N) operands.
    """
    a = [x.to(torch.int64) for x in arrays]
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
    return r.to(torch.int32)


def eltwise_cuda(op: str, q: torch.Tensor, *arrays: torch.Tensor) -> torch.Tensor:
    """Launch the EFU kernel (``csrc/eltwise.cu``) on the current stream."""
    x = arrays[0]
    ell, N = x.shape[-2], x.shape[-1]
    native.require({f"operand {i}": a for i, a in enumerate(arrays)},
                   torch.int32, x.device)
    native.require({"q": q}, torch.int64, x.device)
    if any(a.shape != x.shape for a in arrays) or q.numel() != ell:
        raise ValueError(f"eltwise {op}: shapes {[tuple(a.shape) for a in arrays]}"
                         f" with {q.numel()} primes")
    out = torch.empty_like(x)
    ptrs = [a.data_ptr() for a in arrays] + [None] * (4 - len(arrays))
    lib = native.lib("eltwise")
    err = lib.efu_launch(OPS.index(op), *ptrs, out.data_ptr(), q.data_ptr(),
                         x.numel(), ell, N, native.stream_of(x))
    native.check("eltwise", err, f"eltwise {op}")
    config.count_launch("eltwise", "efu")
    return out
