"""State carried across from numpy arrays: key sets and ciphertexts.

Key material and ciphertexts travel between this package and other holders
(the JAX reference package, files, another process) as plain numpy arrays of
u32 residues, so both sides compute on the same bytes:

* :func:`keyset_from_numpy` builds a :class:`~repro_torch.core.keys.KeySet`
  from the ternary secret, and each evaluation key's PRNG seed and b-halves
  (the a-halves are regenerated from the seed, PRNG evk §V-B);
* :func:`ciphertext_from_numpy` / :func:`ciphertext_to_numpy` convert a
  ciphertext from and to ``(a, b, scale, basis, domain)``;
* :func:`bootcontext_from_numpy` builds a bootstrapping context from its key
  set and its EvalMod and BSGS settings, the transform diagonals rebuilt from
  this package's own canonical embedding;
* :func:`lm_params_from_numpy` builds the LM decoder from the reference's
  parameter tree.
"""
from __future__ import annotations

import numpy as np

from .core import bootstrap as B
from .core import keys as K
from .core import poly as pl
from .core.params import CkksParams


def evalkey_from_numpy(seed: int, b_halves, basis: tuple[int, ...],
                       device="cuda") -> K.EvalKey:
    """One evaluation key from its seed and its dnum (ℓ+K, N) u32 b-halves."""
    b = [pl.RnsPoly(pl.to_tensor(np.asarray(x), device), tuple(basis), pl.NTT)
         for x in b_halves]
    return K.EvalKey(seed=int(seed), b=b, basis=tuple(basis))


def keyset_from_numpy(params: CkksParams, s_small: np.ndarray,
                      relin: tuple[int, list], galois: dict[int, tuple[int, list]],
                      device="cuda") -> K.KeySet:
    """A KeySet from the secret's (N,) ternary coefficients, the relin key's
    (seed, b-halves) and {galois element: (seed, b-halves)}."""
    basis = params.q + params.p
    sk = K.SecretKey(np.asarray(s_small, dtype=np.int8).copy())
    return K.KeySet(
        params=params, sk=sk,
        relin=evalkey_from_numpy(*relin, basis, device),
        galois={int(g): evalkey_from_numpy(seed, bs, basis, device)
                for g, (seed, bs) in galois.items()})


def ciphertext_from_numpy(a: np.ndarray, b: np.ndarray, scale: float,
                          basis: tuple[int, ...], domain: str,
                          device="cuda") -> K.Ciphertext:
    """A Ciphertext from (ℓ, N) u32 residue arrays of both components."""
    if domain not in (pl.COEFF, pl.NTT):
        raise ValueError(f"unknown domain {domain!r}")
    basis = tuple(int(q) for q in basis)
    return K.Ciphertext(pl.RnsPoly(pl.to_tensor(a, device), basis, domain),
                        pl.RnsPoly(pl.to_tensor(b, device), basis, domain),
                        float(scale))


def ciphertext_to_numpy(ct: K.Ciphertext) -> dict:
    """{"a", "b": u32 arrays, "scale", "basis", "domain"} of a ciphertext."""
    assert ct.a.domain == ct.b.domain
    return {"a": pl.to_numpy(ct.a.data), "b": pl.to_numpy(ct.b.data),
            "scale": ct.scale, "basis": ct.basis, "domain": ct.a.domain}


def bootcontext_from_numpy(params: CkksParams, s_small: np.ndarray,
                           relin: tuple[int, list],
                           galois: dict[int, tuple[int, list]], K_range: int,
                           cheb_coeffs: np.ndarray, bs: int, use_min_ks: bool,
                           device="cuda") -> B.BootContext:
    """A BootContext from its key set (as :func:`keyset_from_numpy` takes
    it), EvalMod range, Chebyshev coefficients, baby-step count and key-switch
    mode; the diagonals come from :func:`bootstrap.embedding_diagonals`."""
    cts_diags, stc_diags = B.embedding_diagonals(params.N)
    return B.BootContext(
        params=params,
        keys=keyset_from_numpy(params, s_small, relin, galois, device),
        K_range=int(K_range), cheb_coeffs=np.asarray(cheb_coeffs, dtype=np.float64),
        bs=int(bs), cts_diags=cts_diags, stc_diags=stc_diags,
        use_min_ks=bool(use_min_ks))


def lm_params_from_numpy(tree: dict, cfg, device="cuda"):
    """A :class:`~repro_torch.models.transformer.Transformer` holding the
    reference's LM parameter tree given as numpy arrays: nested dicts with
    the layers stacked on a leading axis (``tree["layers"]["attn"]["wq"][i]``
    is layer i's ``layers.i.attn.wq``).  Every leaf of the tree must be
    used, each in the port's dtype for ``cfg``."""
    import torch

    from .models import transformer as T
    model = T.Transformer(cfg, device)

    def leaves(node, path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, node

    given = dict(leaves(tree))
    used = set()
    with torch.no_grad():
        for name, w in model.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers":
                path, index = ("layers", *parts[2:]), (int(parts[1]),)
            else:
                path, index = tuple(parts), ()
            if path not in given:
                raise KeyError(f"{name}: no {'/'.join(path)} in the tree")
            a = np.array(np.asarray(given[path])[index], dtype=np.float32)
            if tuple(a.shape) != tuple(w.shape):
                raise ValueError(f"{name}: shape {a.shape}, expected {tuple(w.shape)}")
            w.copy_(torch.from_numpy(a))
            used.add(path)
    if set(given) != used:
        raise KeyError(f"leaves not used: {sorted(set(given) - used)}")
    return model
