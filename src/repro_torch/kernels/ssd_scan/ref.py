"""Plain PyTorch version of the mamba2 SSD scan: the sequential token
recurrence.  Twin of ``repro/kernels/ssd_scan/ref.py``, which also returns
the final state here:

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * B_t x_t^T
    y_t = C_t . h_t + D * x_t

Shapes: x (B, L, H, P), dt (B, L, H), a (H,), Bm/Cm (B, L, G, N) with G
dividing H (G = H is the pre-expanded layout of the TPU kernel; head h reads
group h // (H / G), as ``jnp.repeat`` expands them), D (H,).  Every product
in f32; y in x's dtype, the final state (B, H, N, P) in f32.
"""
from __future__ import annotations

from typing import Tuple

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
    xf = x.float()
    dtf = dt.float()
    Bf = expand_groups(Bm.float(), H)
    Cf = expand_groups(Cm.float(), H)
    af = a.float()
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    y = torch.empty((Bsz, L, H, P), dtype=torch.float32, device=x.device)
    for t in range(L):
        decay = torch.exp(dtf[:, t] * af[None, :])  # (B, H)
        h = h * decay[..., None, None] + torch.einsum(
            "bhn,bh,bhp->bhnp", Bf[:, t], dtf[:, t], xf[:, t])
        y[:, t] = torch.einsum("bhn,bhnp->bhp", Cf[:, t], h)
    y = y + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), h
