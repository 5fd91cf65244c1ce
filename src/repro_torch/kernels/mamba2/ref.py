"""Plain PyTorch versions of the Mamba-2 SSD scan (scalar decay per head):
the sequential recurrence (``ssd_sequential``, the ground truth) and the
masked chunked form (``ssd_chunked_ref``), ported from
``repro/kernels/mamba2/ref.py`` (``ssd_sequential``, ``ssd_chunked_jnp``).

Per token, per head (P x N state h):
    h   <- e^{la_t} h + (dt_t x_t) B_t^T
    y_t  = h C_t
``D * x`` is added outside the scan, as in the JAX package.
"""
from __future__ import annotations

import torch

# the orders of scan_tile.cuh's reverse walk, shared with the WKV backward
from repro_torch.kernels.rwkv6.ref import in_order, xor_tree


def ssd_sequential(xh, dt, la, Bc, Cc, h0):
    """xh (B, S, nh, P); dt, la (= A * dt) (B, S, nh); Bc, Cc (B, S, N);
    h0 (B, nh, P, N). Returns (y (B, S, nh, P), h (B, nh, P, N))."""
    h, ys = h0, []
    for t in range(xh.shape[1]):
        a = torch.exp(la[:, t])                                   # (B, nh)
        upd = torch.einsum("bhp,bn->bhpn", xh[:, t] * dt[:, t][..., None],
                           Bc[:, t])
        h = a[..., None, None] * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cc[:, t]))
    return torch.stack(ys, 1), h


def ssd_chunked_ref(xh, dt, la, Bc, Cc, h0, chunk: int = 64):
    """Chunked SSD (arXiv:2405.21060 block decomposition): the masked
    (C, C) decay tile Gamma per head, then the inter-chunk state scan.
    ``S % chunk != 0`` runs the sequential recurrence, as in the JAX
    package."""
    B, S, nh, P = xh.shape
    N = Bc.shape[-1]
    C = min(chunk, S)
    if S % C != 0:
        return ssd_sequential(xh, dt, la, Bc, Cc, h0)
    nc = S // C

    def resh(t):  # (B, S, ...) -> (nc, B, C, ...)
        return t.reshape((B, nc, C) + t.shape[2:]).transpose(0, 1)

    xc, dtc, lac, Bcc, Ccc = resh(xh), resh(dt), resh(la), resh(Bc), resh(Cc)
    tri = torch.tril(torch.ones(C, C, dtype=torch.bool,
                                device=xh.device))[None, :, :, None]
    h, ys = h0, []
    for c in range(nc):
        x_, dt_, la_, B_, C_ = xc[c], dtc[c], lac[c], Bcc[c], Ccc[c]
        L = torch.cumsum(la_, dim=1)                              # (B, C, nh)
        yin = torch.einsum("bcn,bhpn,bch->bchp", C_, h, torch.exp(L))
        ratio = L[:, :, None, :] - L[:, None, :, :]
        G = torch.exp(torch.where(tri, ratio,
                                  torch.full_like(ratio, -torch.inf)))
        scores = torch.einsum("btn,bsn,btsh->btsh", C_, B_, G)
        xdt = x_ * dt_[..., None]
        yintra = torch.einsum("btsh,bshp->bthp", scores, xdt)
        Lend = L[:, -1:, :]
        w_s = torch.exp(Lend - L)
        h = torch.exp(Lend[:, 0, :, None, None]) * h + \
            torch.einsum("bchp,bcn,bch->bhpn", xdt, B_, w_s)
        ys.append(yin + yintra)
    y = torch.stack(ys, 0).transpose(0, 1).reshape(B, S, nh, P)
    return y, h


def ssd_split_ref(xh, dt, la, Bc, Cc, h0, groups: int):
    """The CUDA kernel's order (``csrc/ssd.cu``) in plain torch: the
    recurrence token by token, each state row's N values dealt to
    ``groups`` threads in chunks of 4 (n goes to group (n // 4) % groups);
    y_t[p] is the sum of the groups' partials in group order, each partial
    adding h[p, n] C_t[n] over its n in ascending order. (The kernel fuses
    each product into its add, so the two round differently: they agree to
    fp32 rounding.)"""
    B, S, nh, P = xh.shape
    N = Bc.shape[-1]
    if groups < 1 or N % (4 * groups):
        raise ValueError(f"groups {groups}: 4 * groups must divide N = {N}")
    members = [[n for n in range(N) if (n // 4) % groups == g]
               for g in range(groups)]
    h, ys = h0, []
    for t in range(S):
        a = torch.exp(la[:, t])[..., None, None]                 # (B, nh, 1, 1)
        xdt = (xh[:, t] * dt[:, t][..., None])[..., None]         # (B, nh, P, 1)
        h = a * h + xdt * Bc[:, t][:, None, None, :]
        prod = h * Cc[:, t][:, None, None, :]                     # (B, nh, P, N)
        y = None
        for ns in members:
            part = prod[..., ns[0]]
            for n in ns[1:]:
                part = part + prod[..., n]
            y = part if y is None else y + part
        ys.append(y)
    return torch.stack(ys, 1), h


def ssd_backward_ref(xh, dt, la, Bc, Cc, h0, dy, dh=None):
    """The gradients of ``ssd_chunked_ref``'s ``(y, h)`` given ``dy``
    (B, S, nh, P) and ``dh`` (B, nh, P, N; None is zero): a reverse scan,
    token by token, the plain version of ``csrc/ssd_bwd.cu``. Returns
    ``(dxh, ddt, dla, dBc, dCc, dh0)``.

    With a_t = e^{la_t}, h_t the state after token t (y_t = h_t C_t) and
    H_t = dL/dh_t = dy_t C_t^T + a_{t+1} H_{t+1} (plus dh at the last
    token), per (b, head):
        dxh_t[p] = dt_t sum_n H_t[p, n] B_t[n]
        ddt_t = sum_{p, n} H_t[p, n] x_t[p] B_t[n]
        dla_t = a_t sum_{p, n} H_t[p, n] h_{t-1}[p, n]
        dB_t[n] = sum_heads sum_p H_t[p, n] dt_t x_t[p]
        dC_t[n] = sum_heads sum_p h_t[p, n] dy_t[p],   dh0 = a_1 H_1.
    The states come from running the recurrence forward from ``h0``, never
    from inverting it (a division by a_t, which reaches 1e-7)."""
    B, S, nh, P = xh.shape
    a = torch.exp(la)                                           # (B, S, nh)
    xdt = xh * dt[..., None]
    states, h = [h0], h0
    for t in range(S):
        h = a[:, t][..., None, None] * h + \
            xdt[:, t][..., :, None] * Bc[:, t][:, None, None, :]
        states.append(h)
    Hn = torch.zeros_like(h0) if dh is None else dh   # a_{t+1} H_{t+1}
    dxh, dBc, dCc = (torch.empty_like(t) for t in (xh, Bc, Cc))
    ddt, dla = torch.empty_like(dt), torch.empty_like(la)
    for t in range(S - 1, -1, -1):
        Ht = Hn + dy[:, t][..., :, None] * Cc[:, t][:, None, None, :]
        hb = torch.einsum("bhpn,bn->bhp", Ht, Bc[:, t])
        dxh[:, t] = dt[:, t][..., None] * hb
        ddt[:, t] = (hb * xh[:, t]).sum(-1)
        dla[:, t] = a[:, t] * (Ht * states[t]).sum((-2, -1))
        dBc[:, t] = torch.einsum("bhpn,bhp->bn", Ht, xdt[:, t])
        dCc[:, t] = torch.einsum("bhpn,bhp->bn", states[t + 1], dy[:, t])
        Hn = a[:, t][..., None, None] * Ht
    return dxh, ddt, dla, dBc, dCc, Hn


def ssd_backward_split_ref(xh, dt, la, Bc, Cc, h0, dy, dh=None):
    """The CUDA kernel's order of sums (``csrc/ssd_bwd.cu``) in plain torch:
    the same reverse scan as ``ssd_backward_ref``, each sum taken as the
    kernel takes it. (The kernel fuses each product into its add, so the two
    round differently: they agree to fp32 rounding.)

    A thread holds rows ``M g .. M g + M - 1`` (M = P / 8, 8 row groups
    g) of 4 columns; a warp holds every row of four neighbouring column
    groups, its lanes ``4 g + c``. hb = H_t B_t adds a thread's 4 columns in
    order, the warp's four column groups by ``xor_tree``, then the N / 16
    warps in order (dx = dt hb). dB's and dC's sums over p add a thread's
    rows in order, then the 8 row groups by ``xor_tree``; dC is taken from the state
    before the token, a_t (h_{t-1}^T dy_t) + B_t dt_t (x_t . dy_t), the dot
    as lane l's p = l, l + 32, ... in order, then the 32 lanes by
    ``xor_tree``. ddt (x . hb of a thread's rows, in order) and dla (a
    thread's H h_{t-1} products in row then column order) add the warp's 32
    lanes by ``xor_tree``, then the warps in order. dB and dC add the heads
    in ascending order."""
    B, S, nh, P = xh.shape
    N = Bc.shape[-1]
    if P % 16 or N % 16:
        raise ValueError(f"(P, N) = ({P}, {N}): the kernel takes P % 16 == 0 "
                         f"and N % 16 == 0")
    M, W = P // 8, N // 16
    a = torch.exp(la)
    xdt = xh * dt[..., None]
    states, h = [h0], h0
    for t in range(S):
        h = a[:, t][..., None, None] * h + \
            xdt[:, t][..., :, None] * Bc[:, t][:, None, None, :]
        states.append(h)
    Hn = torch.zeros_like(h0) if dh is None else dh
    dxh, dBc, dCc = (torch.empty_like(t) for t in (xh, Bc, Cc))
    ddt, dla = torch.empty_like(dt), torch.empty_like(la)
    lanes = -(-P // 32) * 32

    def tiles(z):  # (B, nh, P, N) -> (B, nh, W, 8 g, 4 c, M rows, 4 cols)
        return z.reshape(B, nh, 8, M, W, 4, 4).permute(0, 1, 4, 2, 5, 3, 6)

    for t in range(S - 1, -1, -1):
        at, dtt = a[:, t][..., None], dt[:, t][..., None]          # (B, nh, 1)
        Ht = Hn + dy[:, t][..., :, None] * Cc[:, t][:, None, None, :]
        hp = states[t]
        # hb: the thread's 4 columns, its warp's 4 column groups, the warps
        hbt = in_order((Ht * Bc[:, t][:, None, None, :])
                       .reshape(B, nh, P, W, 4, 4))            # (B,nh,P,W,4)
        dxh[:, t] = dtt * in_order(xor_tree(hbt))
        # ddt, dla: a thread's own sum, the warp's 32 lanes, the warps
        xhb = xh[:, t][..., :, None, None] * hbt               # (B,nh,P,W,4)
        xhb = in_order(xhb.reshape(B, nh, 8, M, W, 4).permute(0, 1, 4, 2, 5, 3))
        ddt[:, t] = in_order(xor_tree(xhb.reshape(B, nh, W, 32)))
        hh = tiles(Ht * hp).reshape(B, nh, W, 8, 4, 4 * M)
        dla[:, t] = at[..., 0] * in_order(
            xor_tree(in_order(hh).reshape(B, nh, W, 32)))
        # dB, dC of a head: the thread's rows, the 8 row groups
        xdt_t = xdt[:, t][..., :, None]
        dB_h = xor_tree(in_order(tiles(Ht * xdt_t).transpose(-1, -2))
                        .transpose(-2, -3).transpose(-1, -2)
                        .reshape(B, nh, W, 4, 4, 8))
        dC_h = xor_tree(in_order(tiles(hp * dy[:, t][..., :, None])
                                 .transpose(-1, -2))
                        .transpose(-2, -3).transpose(-1, -2)
                        .reshape(B, nh, W, 4, 4, 8))
        xd = torch.zeros(B, nh, lanes, dtype=xh.dtype, device=xh.device)
        xd[..., :P] = xh[:, t] * dy[:, t]
        xdy = dt[:, t] * xor_tree(in_order(xd.reshape(B, nh, lanes // 32, 32)
                                           .transpose(-1, -2)))
        dC_h = at * dC_h.reshape(B, nh, N) + \
            Bc[:, t][:, None, :] * xdy[..., None]
        dBc[:, t] = in_order(dB_h.reshape(B, nh, N).transpose(1, 2))
        dCc[:, t] = in_order(dC_h.transpose(1, 2))
        Hn = at[..., None] * Ht
    return dxh, ddt, dla, dBc, dCc, Hn
