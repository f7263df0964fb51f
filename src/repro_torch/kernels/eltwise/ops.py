"""EFU element-wise ops: the CUDA kernel, its plain torch version, the wrapper.

    mul   : a ⊙ b              add/sub  : a ± b             neg : −a
    mac   : a ⊙ b + c ⊙ d      muladd   : a ⊙ b + c
    scale : a · w_i            subscale : (a − b) · w_i     (all mod q_i)

Operands are (…, ℓ, N) int32 residue tensors of one shape; ``scale`` and
``subscale`` take an (ℓ,) column of per-limb scalars.  The primes, Barrett constants and scalar columns come
device-resident from :mod:`repro_torch.core.const_cache`.  The first five ops
are the reference's EFU menu; ``neg``, ``scale`` and ``subscale`` are the
ring ops the reference computes in jnp (``RnsPoly.__neg__``,
``RnsPoly.mul_scalar`` and the sub-then-scale tails of ModDown and rescale).

The kernel reads a strided view in place when it flattens to (outer, ℓ, N)
with rows N words apart and one outer stride (:func:`operand_layout`);
any other operand is copied first, and :func:`copy_counts` counts those
copies.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from repro_torch.core import const_cache
from repro_torch.kernels import config, native

OPS = ("mul", "add", "sub", "mac", "muladd", "neg", "scale", "subscale")
#: The ops of the reference's EFU kernel (``eltwise_pallas``).
REFERENCE_OPS = OPS[:5]
ARITY = {"mul": 2, "add": 2, "sub": 2, "mac": 4, "muladd": 3, "neg": 1,
         "scale": 1, "subscale": 2}
SCALED = ("scale", "subscale")
_CODE = {op: i for i, op in enumerate(OPS)}      # the kernel's op codes

_copies: collections.Counter = collections.Counter()
# (basis, device) → the staged primes and Barrett constants in one lookup:
# the ring ops of an op are host-bound, and two constant-cache lookups per
# launch cost a quarter of the wrapper's host time.
_consts: dict = {}


def copy_counts() -> dict:
    """Operands the kernel wrapper copied because they did not flatten to
    its layout, per op, since the last :func:`reset_copy_counts`."""
    return dict(_copies)


def reset_copy_counts() -> None:
    _copies.clear()


def eltwise(op: str, basis: tuple[int, ...], *arrays: torch.Tensor,
            scalars: np.ndarray | None = None) -> torch.Tensor:
    """The EFU op over ``basis``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if native.on_cuda(*arrays):
        return eltwise_cuda(op, basis, *arrays, scalars=scalars)
    return eltwise_plain(op, basis, *arrays, scalars=scalars)


def _check(op: str, basis: tuple[int, ...], arrays, scalars) -> torch.Size:
    """The operands' shape; raises on a bad op, arity, shape or basis."""
    if ARITY.get(op) != len(arrays):
        raise ValueError(f"eltwise {op!r} with {len(arrays)} operands")
    if (scalars is None) == (op in SCALED):
        raise ValueError(f"eltwise {op!r}: scalars are for {SCALED} only")
    shape = arrays[0].shape
    if (len(shape) < 2 or shape[-2] != len(basis)
            or any(a.shape != shape for a in arrays)):
        raise ValueError(f"eltwise {op}: shapes {[tuple(a.shape) for a in arrays]}"
                         f" with {len(basis)} primes")
    return shape


def eltwise_plain(op: str, basis: tuple[int, ...], *arrays: torch.Tensor,
                  scalars: np.ndarray | None = None) -> torch.Tensor:
    """Plain torch version: int64 products (< 2⁶⁰) and exact ``%``."""
    _check(op, tuple(basis), arrays, scalars)
    q = const_cache.device_q(tuple(basis), arrays[0].device)
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
    elif op == "neg":
        r = -a[0] % q
    else:
        w = const_cache.device_efu_scalars(basis, scalars, a[0].device)[0, :, None]
        r = (a[0] if op == "scale" else (a[0] - a[1]) % q) * w % q
    return r.to(torch.int32)


def operand_layout(t: torch.Tensor) -> tuple[int, int, int] | None:
    """(offset, outer, stride) in words of a (…, ℓ, N) operand that the kernel
    reads in place: its storage offset, the number of leading elements and
    the one stride between them (0 when a broadcast dim repeats one).  None
    when it must be copied: the last dim not contiguous, rows not N words
    apart, leading dims that flatten to no single stride, or a stride that is
    no multiple of 4 words (the kernel's 16-byte accesses)."""
    *lead, ell, N = t.shape
    *lead_strides, row_stride, col_stride = t.stride()
    if (N > 1 and col_stride != 1) or (ell > 1 and row_stride != N):
        return None
    outer, stride = 1, ell * N
    for size, st in reversed(list(zip(lead, lead_strides))):
        if size == 1:
            continue
        if outer == 1:
            stride = st
        elif st != stride * outer:
            return None
        outer *= size
    if outer == 0:
        return t.storage_offset(), 0, ell * N
    if stride % 4:
        return None
    return t.storage_offset(), outer, stride


def eltwise_cuda(op: str, basis: tuple[int, ...], *arrays: torch.Tensor,
                 scalars: np.ndarray | None = None) -> torch.Tensor:
    """Launch the EFU kernel (``csrc/eltwise.cu``) on the operands' card and
    its current stream; views are read in place where :func:`operand_layout`
    allows.  The ring ops of every CKKS op come through here, so the host
    path is kept short."""
    basis = tuple(basis)
    shape = _check(op, basis, arrays, scalars)
    dev = arrays[0].device
    ell, N = len(basis), shape[-1]
    if N % 4:
        raise ValueError(f"eltwise {op}: N = {N} is no multiple of 4")
    views, strides = [], []          # the views stay referenced until launch
    for i, a in enumerate(arrays):
        if a.dtype != torch.int32 or a.device != dev:
            native.require({f"operand {i}": a}, torch.int32, dev, contiguous=False)
        if a.is_contiguous():
            stride = ell * N
        else:
            layout = operand_layout(a)
            if layout is None:
                _copies[op] += 1
                a = a.contiguous()
                layout = operand_layout(a)
            stride = layout[2]
        if a.data_ptr() % 16:
            raise ValueError(f"eltwise {op}: operand {i} is not 16-byte aligned")
        views.append(a)
        strides.append(stride)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    key = (basis, dev)
    consts = _consts.get(key)
    if consts is None:
        consts = _consts[key] = (const_cache.device_q(basis, dev),
                                 const_cache.device_barrett(basis, dev))
    w = (const_cache.device_efu_scalars(basis, scalars, dev).data_ptr()
         if scalars is not None else None)
    pad = 4 - len(arrays)
    with native.on_device(out):
        err = native.lib("eltwise").efu_launch(
            _CODE[op], *(a.data_ptr() for a in views), *[None] * pad,
            *strides, *[0] * pad, out.data_ptr(), ell * N,
            consts[0].data_ptr(), consts[1].data_ptr(), w,
            out.numel() // (ell * N), ell, N, native.stream_of(out))
    native.check("eltwise", err, f"eltwise {op}")
    config.count_launch("eltwise", "efu")
    return out
