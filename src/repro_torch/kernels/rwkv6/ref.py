"""Plain PyTorch versions of the RWKV-6 WKV scan: the sequential recurrence
(``wkv_sequential``, the ground truth) and the masked chunked form
(``wkv_chunked_ref``), ported from ``repro/kernels/rwkv6/ref.py``
(``wkv_sequential``, ``wkv_chunked_jnp``).

Per token, per head (N x N state S):
    o_t = r_t^T S + (r_t . u . k_t) v_t
    S  <- diag(w_t) S + k_t v_t^T

The chunked form is what the TPU kernel (``wkv_pallas``) computes: every
decay ratio exp(Lprev_t - L_s) <= 1, no clamp. JAX's CPU default
(``wkv_chunked_factored``) clamps the log-decay at -3.5; the port follows
the TPU kernel instead (the clamp is inert while every w_t >= e^-3.5).
"""
from __future__ import annotations

import torch


def wkv_sequential(r, k, v, w, u, state0):
    """r, k, v, w (B, S, H, N) fp32; u (H, N); state0 (B, H, N, N).
    Returns (o (B, S, H, N), state (B, H, N, N))."""
    S_ = state0
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        o = torch.einsum("bhn,bhnm->bhm", rt, S_) + \
            torch.einsum("bhn,hn,bhn,bhm->bhm", rt, u, kt, vt)
        S_ = wt[..., None] * S_ + torch.einsum("bhn,bhm->bhnm", kt, vt)
        outs.append(o)
    return torch.stack(outs, 1), S_


def wkv_chunked_ref(r, k, v, w, u, state0, chunk: int = 32):
    """Masked chunked form: intra-chunk masked decay products (<= 1) plus
    the inter-chunk state scan. ``S % chunk != 0`` runs the sequential
    recurrence, as in the JAX package."""
    B, S, H, N = r.shape
    C = min(chunk, S)
    if S % C != 0:
        return wkv_sequential(r, k, v, w, u, state0)
    nc = S // C

    def resh(t):  # (B, S, H, N) -> (nc, B, H, C, N)
        return t.reshape(B, nc, C, H, N).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(w)
    tri = torch.tril(torch.ones(C, C, dtype=torch.bool, device=r.device),
                     diagonal=-1)[None, None, :, :, None]
    S0, outs = state0, []
    for c in range(nc):
        rr, kk, vv, ww = rc[c], kc[c], vc[c], wc[c]          # (B, H, C, N)
        lw = torch.log(ww)
        L = torch.cumsum(lw, dim=2)
        Lprev = L - lw  # log prod of the decays strictly before t
        o_inter = torch.einsum("bhcn,bhnm->bhcm", rr * torch.exp(Lprev), S0)
        # mask inside the exp, as the reference does
        ratio = Lprev[:, :, :, None, :] - L[:, :, None, :, :]  # (B,H,t,s,N)
        dmat = torch.exp(torch.where(tri, ratio,
                                     torch.full_like(ratio, -torch.inf)))
        scores = torch.einsum("bhtn,bhsn,bhtsn->bhts", rr, kk, dmat)
        diag = torch.einsum("bhcn,bhcn,hn->bhc", rr, kk, u)
        o_intra = torch.einsum("bhts,bhsn->bhtn", scores, vv) \
            + diag[..., None] * vv
        Ltot = L[:, :, -1:, :]
        kd = kk * torch.exp(Ltot - L)
        S0 = torch.exp(Ltot[:, :, 0, :, None]) * S0 + \
            torch.einsum("bhsn,bhsm->bhnm", kd, vv)
        outs.append(o_inter + o_intra)
    o = torch.stack(outs, 0).permute(1, 0, 3, 2, 4).reshape(B, S, H, N)
    return o, S0
