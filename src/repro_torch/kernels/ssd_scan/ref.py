"""Plain PyTorch version of the mamba2 SSD scan: the sequential token
recurrence.  Twin of ``repro/kernels/ssd_scan/ref.py``, which also returns
the final state here:

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * B_t x_t^T
    y_t = C_t . h_t + D * x_t

Shapes: x (B, L, H, P), dt (B, L, H), a (H,), Bm/Cm (B, L, G, N) with G
dividing H (G = H is the pre-expanded layout of the TPU kernel; head h reads
group h // (H / G), as ``jnp.repeat`` expands them), D (H,).  Every product
in f32 (in f64 for f64 inputs); y in x's dtype, the final state (B, H, N, P)
in f32 (f64).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def expand_groups(m: torch.Tensor, H: int) -> torch.Tensor:
    """(B, L, G, N) -> (B, L, H, N): head h takes group h // (H / G)."""
    G = m.shape[2]
    return m if G == H else m.repeat_interleave(H // G, dim=2)


def ssd_scan_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(ct)
    dtf = dt.to(ct)
    Bf = expand_groups(Bm.to(ct), H)
    Cf = expand_groups(Cm.to(ct), H)
    af = a.to(ct)
    h = torch.zeros((Bsz, H, N, P), dtype=ct, device=x.device)
    y = torch.empty((Bsz, L, H, P), dtype=ct, device=x.device)
    for t in range(L):
        decay = torch.exp(dtf[:, t] * af[None, :])  # (B, H)
        h = h * decay[..., None, None] + torch.einsum(
            "bhn,bh,bhp->bhnp", Bf[:, t], dtf[:, t], xf[:, t])
        y[:, t] = torch.einsum("bhn,bhnp->bhp", Cf[:, t], h)
    y = y + xf * D.to(ct)[None, None, :, None]
    return y.to(x.dtype), h


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 t rounded to tf32 (11 significant bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds it."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _pieces(t: torch.Tensor, k: int, tf32: bool = False):
    """f32 t as k pieces (each returned in f32), each the rounding of what
    the pieces before it leave, to bf16 (``split_pieces`` in
    csrc/warp_mma.cuh) or to tf32 (``split_tf32``)."""
    out, rest = [], t.float()
    for _ in range(k):
        piece = _tf32(rest) if tf32 else rest.to(torch.bfloat16).float()
        out.append(piece)
        rest = rest - piece
    return out


def _split_product(eq: str, a: torch.Tensor, b: torch.Tensor, ka: int, kb: int,
                   tf32: bool = False) -> torch.Tensor:
    """A product of two f32 operands as the kernels take it on the tensor
    cores: ``a`` in ka pieces, ``b`` in kb, and the products of pieces i, j
    with i + j < max(ka, kb), each exact, summed in f32 (bf16 pieces:
    ``pieces_mma``; two tf32 pieces each: ``mma_3xtf32``, in
    csrc/warp_mma.cuh)."""
    pa, pb = _pieces(a, ka, tf32), _pieces(b, kb, tf32)
    out = None
    for i, p in enumerate(pa):
        for j, q in enumerate(pb):
            if i + j < max(ka, kb):
                term = torch.einsum(eq, p, q)
                out = term if out is None else out + term
    return out


def ssd_scan_chunked_model(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plain model of ``csrc/ssd_scan.cu``'s chunk-parallel scan with the
    kernels' precision split, for the CPU tests (nothing on the card calls
    it).  Stage 1: each chunk's state S_c = (B o w)^T x with w_j =
    exp(cum_Q - cum_j) dt_j; stage 2: h_{c+1} = exp(cum_Q) h_c + S_c over the
    chunks; stage 3: y = exp(cum) (C h_c) + W x + (C_i.B_i dt_i + D) x_i with
    W = C.B^T (once per group) o exp(cum_i - cum_j) o dt_j for j < i, the
    diagonal's coefficient in f64 (where C_i.B_i dt_i nearly cancels D, an
    f32 sum would err by some percent of the row).  The in-chunk cumsum
    is f64 and each exponent its f64 difference rounded to f32 (off the
    diagonal blocks of 16 tokens the kernel takes the decay as the product
    of two such exponentials, through the block's last token: f32 rounding
    apart, the same).  Every
    product takes its f32 operands in pieces (``_split_product``): with bf16
    x, B and C, as bf16 pieces, two for B o w and the states and three for
    W; with f32 x, B and C, every operand as tf32 hi + lo (3xTF32).  Shapes
    and outputs as ``ssd_scan_ref``."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, L)
    nc = -(-L // Q)
    pad = nc * Q - L

    def chunks(t):
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    f32 = x.dtype == torch.float32

    def product(eq, a_, b_, ka, kb):  # ka, kb: bf16 pieces (bf16 inputs)
        return _split_product(eq, a_, b_, 2, 2, tf32=True) if f32 else _split_product(
            eq, a_, b_, ka, kb)

    xq, Bq, Cq = (chunks(t) for t in (x, Bm, Cm))
    dtc = chunks(dt)  # (B, nc, Q, H), 0 past L
    cum = torch.cumsum(dtc.double() * a.double(), dim=2)
    group = torch.arange(H) // (H // G)
    # 1. chunk states
    w = torch.exp((cum[:, :, -1:] - cum).float()) * dtc
    S = product("bcqhn,bcqhp->bchnp", Bq[:, :, :, group] * w[..., None], xq, 2, 1)
    # 2. state passing
    decay = torch.exp(cum[:, :, -1].float())  # (B, nc, H)
    h = torch.zeros((Bsz, H, N, P))
    entering = []
    for c in range(nc):
        entering.append(h)
        h = decay[:, c, :, None, None] * h + S[:, c]
    hin = torch.stack(entering, dim=1)  # (B, nc, H, N, P)
    # 3. chunk output
    CB = product("bcign,bcjgn->bcgij", Cq, Bq, 1, 1)[:, :, group]  # (B,nc,H,Q,Q)
    ci = cum.permute(0, 1, 3, 2)  # (B, nc, H, Q)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool), diagonal=-1)
    W = torch.where(tri, CB * torch.exp((ci[..., :, None] - ci[..., None, :]).float()), 0.0)
    W = W * dtc.permute(0, 1, 3, 2)[..., None, :]
    y = (product("bcihn,bchnp->bcihp", Cq[:, :, :, group], hin, 1, 2)
         * torch.exp(cum.float())[..., None])
    y = y + product("bchij,bcjhp->bcihp", W, xq, 3, 1)
    cbd = (Cq.double() * Bq.double()).sum(-1)[:, :, :, group]  # (B, nc, Q, H): C_i.B_i
    coef = (cbd * dtc.double() + D.double()).float().reshape(Bsz, nc * Q, H)[:, :L]
    y = y.reshape(Bsz, nc * Q, H, P)[:, :L] + x.float() * coef[..., None]
    return y.to(x.dtype), h


def ssd_scan_bwd_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    dy: torch.Tensor,
    dh_final: Optional[torch.Tensor] = None,
    chunk: int = 64,
) -> Tuple[torch.Tensor, ...]:
    """The gradients (dx, ddt, da, dB, dC, dD) of ``ssd_scan_ref``'s (y, h)
    for the cotangents dy (B, L, H, P) and dh_final (B, H, N, P) (None: 0),
    by the explicit chunked backward that ``csrc/ssd_scan_bwd.cu`` computes.
    Per (batch, head, chunk) with cum_i = a s_i, s_i = sum_{t<=i} dt_t within
    the chunk, h_c the state entering it and R_c the gradient of the state
    leaving it (R of the last chunk = dh_final):

        reverse pass  R_{c-1} = exp(cum_last) R_c + sum_i exp(cum_i) C_i dy_i^T
        G_ij = dy_i . x_j,  L_ij = exp(cum_i - cum_j) (j <= i),  W_ij = (C_i . B_j) L_ij dt_j
        dx_j  = sum_i W_ij dy_i + exp(cum_last - cum_j) dt_j R_c^T B_j + D dy_j
        dB_j  = dt_j sum_i G_ij L_ij C_i + exp(cum_last - cum_j) dt_j R_c x_j
        dC_i  = sum_j G_ij L_ij dt_j B_j + exp(cum_i) h_c dy_i
        ddt_j = sum_i G_ij L_ij (C_i . B_j) + exp(cum_last - cum_j) B_j . R_c x_j
                + a sum_{i>=j} dcum_i
        dcum_i = sum_j G_ij W_ij - sum_k G_ki W_ki + exp(cum_i) C_i . h_c dy_i
                 - exp(cum_last - cum_i) dt_i B_i . R_c x_i
                 (+ exp(cum_last) <h_c, R_c> + sum_j exp(cum_last - cum_j) dt_j B_j . R_c x_j
                  at the chunk's last row)
        da = sum dcum_i s_i,  dD_h = sum dy . x

    dB and dC are summed over the heads of each group.  Rows past L (the
    ragged last chunk) are zero with dt = 0, so the chunk's last row carries
    the last real token's cum.  The in-chunk cumsum, its differences and the
    reverse cumsum of dcum are f64.  Products in f32, or in f64 for f64
    inputs (the card's reference).  dx, dB, dC in x's dtype; ddt, da, dD in
    f32 (f64 for f64 inputs).  The result does not depend on ``chunk``
    beyond rounding."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, L)
    nc = -(-L // Q)
    pad = nc * Q - L

    def chunks(t):  # (B, L, H, ...) -> (B, nc, H, Q, ...), zero past L
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        t = t.reshape(Bsz, nc, Q, *t.shape[2:])
        return t.transpose(2, 3)

    xq, dyq = chunks(x.to(ct)), chunks(dy.to(ct))  # (B, nc, H, Q, P)
    Bq = chunks(expand_groups(Bm.to(ct), H))  # (B, nc, H, Q, N)
    Cq = chunks(expand_groups(Cm.to(ct), H))
    dtq = chunks(dt.to(ct))  # (B, nc, H, Q)
    s64 = torch.cumsum(dtq.double(), dim=-1)
    cum64 = s64 * a.double()[None, None, :, None]
    cum, last = cum64.to(ct), cum64[..., -1:]
    e_in = torch.exp(cum)  # exp(cum_i)
    e_out = torch.exp((last - cum64).to(ct))  # exp(cum_last - cum_j)
    w_out = e_out * dtq
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    Lm = torch.exp(torch.where(tri, cum64[..., :, None] - cum64[..., None, :], -torch.inf).to(ct))

    # states entering each chunk (forward), and the reverse pass
    S = torch.einsum("bchj,bchjn,bchjp->bchnp", w_out, Bq, xq)
    Sb = torch.einsum("bchi,bchin,bchip->bchnp", e_in, Cq, dyq)
    decay = torch.exp(last[..., 0].to(ct))  # (B, nc, H)
    h = torch.zeros((Bsz, H, N, P), dtype=ct, device=x.device)
    R = (torch.zeros_like(h) if dh_final is None else dh_final.to(ct))
    hin, Rout = [], [None] * nc
    for c in range(nc):
        hin.append(h)
        h = decay[:, c, :, None, None] * h + S[:, c]
    for c in reversed(range(nc)):
        Rout[c] = R
        R = decay[:, c, :, None, None] * R + Sb[:, c]
    hin, Rc = torch.stack(hin, dim=1), torch.stack(Rout, dim=1)  # (B, nc, H, N, P)

    CB = torch.einsum("bchin,bchjn->bchij", Cq, Bq)
    Pm = torch.einsum("bchip,bchjp->bchij", dyq, xq) * Lm  # G o L
    W = CB * Lm * dtq[..., None, :]
    Rx = torch.einsum("bchnp,bchjp->bchjn", Rc, xq)
    hdy = torch.einsum("bchnp,bchip->bchin", hin, dyq)
    dx = (torch.einsum("bchij,bchip->bchjp", W, dyq)
          + w_out[..., None] * torch.einsum("bchnp,bchjn->bchjp", Rc, Bq)
          + D.to(ct)[None, None, :, None, None] * dyq)
    dB = (dtq[..., None] * torch.einsum("bchij,bchin->bchjn", Pm, Cq) + w_out[..., None] * Rx)
    dC = (torch.einsum("bchij,bchjn->bchin", Pm * dtq[..., None, :], Bq)
          + e_in[..., None] * hdy)
    v = (Bq * Rx).sum(-1)  # B_j . R_c x_j
    Z = Pm * CB * dtq[..., None, :]  # G o W
    dcum = (Z.sum(-1) - Z.sum(-2) + e_in * (Cq * hdy).sum(-1) - w_out * v).double()
    dcum[..., -1] += (torch.exp(last[..., 0]) * (hin.double() * Rc.double()).sum((-2, -1))
                      + (w_out * v).double().sum(-1))
    rev = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = ((Pm * CB).sum(-2) + e_out * v).double() + a.double()[None, None, :, None] * rev
    da = (dcum * s64).sum((0, 1, 3))
    dD = (dyq * xq).sum((0, 1, 3, 4))

    def unchunk(t):  # (B, nc, H, Q, ...) -> (B, L, H, ...)
        t = t.transpose(2, 3)
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :L]

    def group_sum(t):  # (B, L, H, N) -> (B, L, G, N)
        return t.reshape(Bsz, L, G, H // G, N).sum(3)

    out_t = torch.float64 if ct == torch.float64 else torch.float32
    return (unchunk(dx).to(x.dtype), unchunk(ddt).to(out_t), da.to(out_t),
            group_sum(unchunk(dB)).to(Bm.dtype), group_sum(unchunk(dC)).to(Cm.dtype),
            dD.to(out_t))


def ssd_scan_bwd_chunked_model(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    dy: torch.Tensor,
    dh_final: Optional[torch.Tensor] = None,
    chunk: int = 64,
    head_block: int = 8,
) -> Tuple[torch.Tensor, ...]:
    """A plain model of ``csrc/ssd_scan_bwd.cu``'s decomposition with the
    kernels' precision split, for the CPU tests (nothing on the card calls
    it).  Outputs as ``ssd_scan_bwd_ref``.  Per chunk of ``chunk`` tokens:

    * the forward's chunk states and state passing recompute the entering
      states h_c (as ``ssd_scan_chunked_model``; bf16 inputs keep them as
      two bf16 pieces); the backward chunk states (exp(cum) o dy)^T C and the
      reverse pass give R_c;
    * per head: P^T = (x dy^T) o L^T on the causal entries only (i >= j; the
      rest are zeros, which add nothing) and Z^T = P^T o B C^T, whose row sums
      are vcol and whose dt-weighted column sums are rowz; dC = (exp(cum) o
      dy) h_c^T + (P o dt) B in one sum, its first part dotted with C first
      (exp(cum_i) u_i); dx = dt o (K^T dy + (e_out o B) R_c) + D dy with K^T =
      B C^T o L^T; dB = dt o ((e_out o x) R_c^T + P^T C), its first part
      dotted with B first (e_out_j v_j); dcum = rowz - dt vcol + exp(cum) u -
      dt e_out v (f64), at the chunk's last row also exp(cum_last) <h_c, R_c>
      + sum_j dt_j e_out_j v_j; ddt = vcol + e_out v + a revcumsum(dcum); dD
      the sum of G's diagonal;
    * dB and dC summed over each block of ``head_block`` heads of a group in
      head order (the last block of a group takes what is left), then over
      the group's blocks in order.

    Every product of the backward's own kernels takes its f32 operands as
    tf32 hi + lo, three passes (lo.hi, hi.lo, hi.hi): hi the value cut to
    tf32, lo the remainder (exact in f32) cut to tf32 as the tensor cores read
    it; a bf16 operand is exact in tf32, so its lo piece is 0, as the kernel
    skips it.  The in-chunk cumsum is f64 and each exponent
    its f64 difference rounded to f32."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    Q = min(chunk, L)
    nc = -(-L // Q)
    pad = nc * Q - L
    group = torch.arange(H) // hpg

    def chunks(t):  # (B, L, X, ...) -> (B, nc, X, Q, ...) f32, zero past L
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(Bsz, nc, Q, *t.shape[2:]).transpose(2, 3)

    def trunc(t):  # t cut to tf32, as the tensor cores read an f32 operand
        return (t.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)

    def split(t):  # ssd_scan_bwd.cu's split: hi = x cut to tf32, lo = the rest, cut
        hi = trunc(t)
        return hi, trunc(t.float() - hi)

    def tc(eq, a_, b_):
        (ah, al), (bh, bl) = split(a_), split(b_)
        return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)

    xq, dyq = chunks(x), chunks(dy)  # (B, nc, H, Q, P)
    Bg, Cg = chunks(Bm), chunks(Cm)  # (B, nc, G, Q, N)
    Bq, Cq = Bg[:, :, group], Cg[:, :, group]  # (B, nc, H, Q, N)
    dtq = chunks(dt)  # (B, nc, H, Q)
    s64 = torch.cumsum(dtq.double(), dim=-1)
    cum = s64 * a.double()[None, None, :, None]
    last = cum[..., -1:]
    e_in = torch.exp(cum.float())
    e_out = torch.exp((last - cum).float())
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))  # [i, j]: j <= i
    Lt = torch.where(tri.T, torch.exp((cum[..., None, :] - cum[..., :, None]).float()), 0.0)

    # 0. the entering states, as the forward's kernels 1-2 compute them
    if x.dtype == torch.float32:
        S = tc("bchjn,bchjp->bchnp", Bq * (e_out * dtq)[..., None], xq)
    else:
        S = _split_product("bchjn,bchjp->bchnp", Bq * (e_out * dtq)[..., None], xq, 2, 1)
    decay = torch.exp(last[..., 0].float())  # (B, nc, H)
    h = torch.zeros((Bsz, H, N, P))
    hin = []
    for c in range(nc):
        if x.dtype == torch.float32:
            hin.append(h)
        else:  # two bf16 pieces
            hi = h.to(torch.bfloat16).float()
            hin.append(hi + (h - hi).to(torch.bfloat16).float())
        h = decay[:, c, :, None, None] * h + S[:, c]
    hin = torch.stack(hin, dim=1)  # (B, nc, H, N, P)
    # 1-2. the backward chunk states and the reverse pass
    Sb = tc("bchin,bchip->bchnp", Cq, e_in[..., None] * dyq)
    R = torch.zeros((Bsz, H, N, P)) if dh_final is None else dh_final.float()
    Rout = [None] * nc
    for c in reversed(range(nc)):
        Rout[c] = R
        R = decay[:, c, :, None, None] * R + Sb[:, c]
    Rc = torch.stack(Rout, dim=1)  # (B, nc, H, N, P)

    # 3. per chunk and head
    BC = tc("bcgjn,bcgin->bcgji", Bg, Cg)[:, :, group]  # B.C^T (j, i), once per group
    Gt = tc("bchjp,bchip->bchji", xq, dyq)
    Pt = Gt * Lt
    Zt = Pt * BC  # Z^T: G o L o C.B^T at (j, i)
    vcol = Zt.sum(-1)
    rowz = (Zt * dtq[..., :, None]).sum(-2)
    acc = tc("bchip,bchnp->bchin", e_in[..., None] * dyq, hin)
    eu = (Cq * acc).sum(-1)  # exp(cum_i) C_i . h_c dy_i
    dC = acc + tc("bchji,bchjn->bchin", Pt * dtq[..., :, None], Bq)
    dx = (dtq[..., None] * (tc("bchji,bchip->bchjp", BC * Lt, dyq)
                            + tc("bchjn,bchnp->bchjp", e_out[..., None] * Bq, Rc))
          + D.float()[None, None, :, None, None] * dyq)
    acc = tc("bchjp,bchnp->bchjn", e_out[..., None] * xq, Rc)
    ev = (Bq * acc).sum(-1)  # exp(cum_last - cum_j) B_j . R_c x_j
    dB = dtq[..., None] * (acc + tc("bchji,bchin->bchjn", Pt, Cq))
    dtd = dtq.double()
    dcum = (rowz.double() - dtd * vcol.double() + eu.double() - dtd * ev.double())
    dcum[..., -1] += (torch.exp(last[..., 0]) * (hin.double() * Rc.double()).sum((-2, -1))
                      + (dtd * ev.double()).sum(-1))
    rev = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = vcol.double() + ev.double() + a.double()[None, None, :, None] * rev
    da = (dcum * s64).sum((0, 1, 3))
    dD = torch.diagonal(Gt, dim1=-2, dim2=-1).double().sum((0, 1, 3))

    def unchunk(t):  # (B, nc, X, Q, ...) -> (B, L, X, ...)
        t = t.transpose(2, 3)
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :L]

    def group_sum(t):  # (B, L, H, N): head blocks in head order, then the blocks
        out = []
        for grp in range(G):
            total = None
            for h0 in range(grp * hpg, (grp + 1) * hpg, head_block):
                part = t[:, :, h0]
                for hh in range(h0 + 1, min(h0 + head_block, (grp + 1) * hpg)):
                    part = part + t[:, :, hh]
                total = part if total is None else total + part
            out.append(total)
        return torch.stack(out, dim=2)

    return (unchunk(dx).to(x.dtype), unchunk(ddt).float(), da.float(),
            group_sum(unchunk(dB)).to(Bm.dtype), group_sum(unchunk(dC)).to(Cm.dtype),
            dD.float())
