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


def wkv_split_ref(r, k, v, w, u, state0, groups: int):
    """The CUDA kernel's order (``csrc/wkv.cu``) in plain torch: the
    recurrence token by token, each state column's N values split into
    ``groups`` runs of N / groups consecutive n; o_t[j] is the sum of the
    runs' partials in run order, each partial adding
    r_n (S[n, j] + u_n k_n v_j) over its run in ascending n, S read before
    it is updated. (The kernel fuses each product into its add, so the two
    round differently: they agree to fp32 rounding.)"""
    B, S, H, N = r.shape
    if groups < 1 or N % groups:
        raise ValueError(f"groups {groups} must divide N = {N}")
    M = N // groups
    S_, outs = state0, []
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]     # (B, H, N)
        kv = kt[..., :, None] * vt[..., None, :]                # (B, H, n, j)
        term = rt[..., :, None] * (u[None, :, :, None] * kv + S_)
        o = None
        for g in range(groups):
            part = term[..., g * M, :]
            for n in range(g * M + 1, (g + 1) * M):
                part = part + term[..., n, :]
            o = part if o is None else o + part
        S_ = wt[..., None] * S_ + kv
        outs.append(o)
    return torch.stack(outs, 1), S_


def wkv_backward_ref(r, k, v, w, u, state0, do, dstate=None):
    """The gradients of ``wkv_chunked_ref``'s ``(o, state)`` given ``do``
    (B, S, H, N) and ``dstate`` (B, H, N, N; None is zero): a reverse scan,
    token by token, the plain version of ``csrc/wkv_bwd.cu``. Returns
    ``(dr, dk, dv, dw, du, dstate0)``.

    With S_{t-1} the state before token t, G_t = dL/dS_t (G_S = dstate)
    and vd_t = v_t . do_t, each per (b, h):
        G_{t-1}[n, j] = w_t[n] G_t[n, j] + r_t[n] do_t[j]
        dr_t[n] = sum_j S_{t-1}[n, j] do_t[j] + u[n] k_t[n] vd_t
        dk_t[n] = sum_j G_t[n, j] v_t[j] + u[n] r_t[n] vd_t
        dv_t[j] = sum_n G_t[n, j] k_t[n] + (sum_n r_t[n] u[n] k_t[n]) do_t[j]
        dw_t[n] = sum_j G_t[n, j] S_{t-1}[n, j]
        du[h, n] = sum_{b, t} r_t[n] k_t[n] vd_t,   dstate0 = G_0.
    The states S_{t-1} come from running the recurrence forward from
    ``state0``, never from inverting it (a division by w_t)."""
    B, S, H, N = r.shape
    states, S_ = [], state0
    for t in range(S):
        states.append(S_)
        S_ = w[:, t][..., None] * S_ + \
            k[:, t][..., :, None] * v[:, t][..., None, :]
    G = torch.zeros_like(state0) if dstate is None else dstate
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    for t in range(S - 1, -1, -1):
        rt, kt, vt, wt, dot = r[:, t], k[:, t], v[:, t], w[:, t], do[:, t]
        Sp = states[t]
        vd = (vt * dot).sum(-1, keepdim=True)                   # (B, H, 1)
        dr[:, t] = torch.einsum("bhnj,bhj->bhn", Sp, dot) + u * kt * vd
        dk[:, t] = torch.einsum("bhnj,bhj->bhn", G, vt) + u * rt * vd
        dv[:, t] = torch.einsum("bhnj,bhn->bhj", G, kt) + \
            (rt * u * kt).sum(-1, keepdim=True) * dot
        dw[:, t] = (G * Sp).sum(-1)
        du = du + (rt * kt * vd).sum(0)
        G = wt[..., None] * G + rt[..., :, None] * dot[..., None, :]
    return dr, dk, dv, dw, du, G


def xor_tree(x):
    """Sum the last axis (a power of two long) as the backward kernels' lane
    halving does (``csrc/scan_tile.cuh``, ``lane_halve``): pairs across the
    top bit first, ((x_0 + x_h) + ...)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def in_order(x):
    """Sum the last axis from first to last: one thread's chain."""
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def wkv_backward_split_ref(r, k, v, w, u, state0, do, dstate=None):
    """The CUDA kernel's order of sums (``csrc/wkv_bwd.cu``) in plain torch:
    the same reverse scan as ``wkv_backward_ref``, each sum taken as the
    kernel takes it. (The kernel fuses each product into its add, so the two
    round differently: they agree to fp32 rounding.)

    A thread holds M = N / 16 neighbouring rows of 8 columns; the CG = N /
    8 lanes of a row group share its rows, and a warp holds 16 rows. A sum
    over j (dr's, dk's, dw's and v . do) adds a thread's 8 columns in
    order, then the lanes' partials by ``xor_tree``. dv's sum over n adds a
    thread's M rows in order, the warp's row groups by ``xor_tree``, then
    the N / 16 warps in order; c_t = sum_n r u k is lane
    l's n = l, l + 32, ... in order, then the 32 lanes by ``xor_tree``. du
    adds t descending, then b ascending."""
    B, S, H, N = r.shape
    if N % 16:
        raise ValueError(f"head size {N}: the kernel takes multiples of 16")
    M, CG = N // 16, N // 8
    RL = 32 // CG
    states, S_ = [], state0
    for t in range(S):
        states.append(S_)
        S_ = w[:, t][..., None] * S_ + \
            k[:, t][..., :, None] * v[:, t][..., None, :]
    G = torch.zeros_like(state0) if dstate is None else dstate
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_b = torch.zeros(B, H, N, dtype=r.dtype, device=r.device)
    lanes = -(-N // 32) * 32

    def over_j(prod):  # (B, H, N, N) [n, j] -> (B, H, N)
        return xor_tree(in_order(prod.reshape(B, H, N, CG, 8)))

    for t in range(S - 1, -1, -1):
        rt, kt, vt, wt, dot = r[:, t], k[:, t], v[:, t], w[:, t], do[:, t]
        Sp = states[t]
        vd = xor_tree(in_order((vt * dot).reshape(B, H, CG, 8)))[..., None]
        dr[:, t] = over_j(Sp * dot[..., None, :]) + u * kt * vd
        dk[:, t] = over_j(G * vt[..., None, :]) + u * rt * vd
        dw[:, t] = over_j(G * Sp)
        gk = (G * kt[..., :, None]).reshape(B, H, N // 16, RL, M, N)
        dvG = in_order(xor_tree(in_order(gk.transpose(-1, -2))
                                .transpose(-1, -2)).transpose(-1, -2))
        ruk = torch.zeros(B, H, lanes, dtype=r.dtype, device=r.device)
        ruk[..., :N] = rt * u * kt
        c = xor_tree(in_order(ruk.reshape(B, H, lanes // 32, 32)
                              .transpose(-1, -2)))
        dv[:, t] = dvG + c[..., None] * dot
        du_b = du_b + rt * kt * vd
        G = wt[..., None] * G + rt[..., :, None] * dot[..., None, :]
    return dr, dk, dv, dw, in_order(du_b.permute(1, 2, 0)), G
