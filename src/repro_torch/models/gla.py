"""Chunked gated linear attention: the shared recurrence core (the port of
``repro.models.gla``).

    S_t = a_t · S_{t−1} + k_t ⊗ v_t          (state S ∈ R^{dk×dv} per head)
    y_t = q_tᵀ · S_t

with per-step, per-head scalar decay a_t = exp(la_t), la_t ≤ 0.  Both
recurrent families reduce to it:

* **Mamba2 SSD**: q=C, k=B, v=Δt·x, la=Δt·A        (state dk=ssm_state, dv=P)
* **xLSTM mLSTM**: q=q/√d, k=k·exp(ĩ) folded, v=v, la=log σ(f̃); the
  normalizer runs as an extra v-column (augmented value trick).

The chunked algorithm (Mamba2 paper §6) splits the sequence into chunks:
intra-chunk an (L×L) decay-masked score matrix, inter-chunk a sequential
loop over per-chunk states.  The state is accumulated in float32.
"""
from __future__ import annotations

import torch

from .layers import MASK_VALUE


def gla_chunked(q, k, v, la, chunk: int = 256):
    """q,k: (B,S,H,dk); v: (B,S,H,dv); la: (B,S,H) log-decays (≤0).

    Returns (y: (B,S,H,dv), final_state: (B,H,dk,dv) float32).
    """
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, S)
    assert S % L == 0, f"seq {S} % chunk {L} != 0"
    n = S // L
    qc, kc, vc = (a.reshape(B, n, L, *a.shape[2:]) for a in (q, k, v))
    lac = la.reshape(B, n, L, H).float()
    c = torch.cumsum(lac, dim=2)                      # inclusive within chunk
    ctot = c[:, :, -1, :]                             # (B, n, H)

    # ---- intra-chunk: masked decay attention --------------------------------
    scores = torch.einsum("bnlhk,bnmhk->bnhlm", qc, kc).float()
    decay = (c[..., :, None, :] - c[..., None, :, :]).movedim(-1, 2)  # (B,n,H,L,L)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    # mask BEFORE the exp: the anti-causal side has decay > 0 (exp overflow),
    # and a where() after the fact leaks NaN into the backward pass
    decay = torch.where(mask, decay, MASK_VALUE)
    w = scores * torch.exp(decay)
    y_intra = torch.einsum("bnhlm,bnmhv->bnlhv", w.to(v.dtype), vc)

    # ---- per-chunk outgoing state -------------------------------------------
    kdecay = torch.exp(ctot[:, :, None, :] - c)       # (B,n,L,H)
    send = torch.einsum("bnlhk,bnlh,bnlhv->bnhkv", kc.float(), kdecay, vc.float())

    # ---- inter-chunk loop ----------------------------------------------------
    state = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
    y_inter = []
    for j in range(n):
        y_inter.append(torch.einsum("blhk,blh,bhkv->blhv", qc[:, j].float(),
                                    torch.exp(c[:, j]), state))
        state = state * torch.exp(ctot[:, j])[:, :, None, None] + send[:, j]
    y = (y_intra.float() + torch.stack(y_inter, dim=1)).reshape(B, S, H, dv)
    return y.to(v.dtype), state


def gla_decode_step(state, q, k, v, la):
    """One-token recurrence.  state: (B,H,dk,dv) float32; q,k: (B,H,dk);
    v: (B,H,dv); la: (B,H).  Returns (y: (B,H,dv), new_state); the new
    state is written into ``state``, which is overwritten (no second copy
    of a large state)."""
    decay = torch.exp(la.float())[:, :, None, None]
    kv = torch.einsum("bhk,bhv->bhkv", k.float(), v.float())
    state = state.mul_(decay).add_(kv)
    y = torch.einsum("bhk,bhkv->bhv", q.float(), state)
    return y.to(v.dtype), state


def gla_reference(q, k, v, la):
    """Sequential oracle for tests (step-by-step recurrence)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    state = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
    ys = []
    for t in range(S):
        y, state = gla_decode_step(state, q[:, t], k[:, t], v[:, t], la[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state
