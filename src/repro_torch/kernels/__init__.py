"""Hand-written Hopper (sm_90a) kernels of the port, each with its plain
PyTorch version and a launch counter.

Layout per kernel: ``<name>/kernel.py`` (ctypes binding of ``csrc/<name>.cu``),
``<name>/ops.py`` (public wrapper), ``<name>/ref.py`` (the plain version).
``_route.py`` decides which of them serves a call, ``_shape.py`` holds each
shape-only op and its launch's scratch, ``_build.py`` compiles every
``csrc/*.cu`` with nvcc on first use.

Kernels:
  flash_attention     - blocked causal/windowed GQA attention, online softmax
  flash_attention_bwd - its backward (dq, dk, dv; FlashAttention-2's math),
                        the port's own: the JAX package trains on XLA
  decode_attention    - split-K flash decoding over a deep KV cache, the
                        visible keys split on the card
  ssd_scan            - mamba2 SSD scan, chunk-parallel (chunk states, a scan
                        over chunks, chunk outputs) on bf16 tensor cores
  ssd_scan_bwd        - its backward (dx, ddt, da, dB, dC, dD; chunk-parallel
                        with a reverse state pass), the port's own
  moe_router          - MoE softmax, top-k and token-major capacity slots
  moe_router_bwd      - the gates' backward (the gradient of the logits)
  fused_augment       - crop + horizontal flip + normalise of uint8 images
  causal_conv         - the mamba2 mixer's depthwise causal conv (width 4),
                        bias and SiLU over (x, B, C), read in place from the
                        in_proj output; the port's own (XLA fuses it in JAX)
  causal_conv_bwd     - its backward (dx; dw and db in a fixed order)
  rms_norm            - RMSNorm over the last dim, plain (block, final and
                        qk norms) or gated by SiLU (the mamba2 mixer's norm,
                        the gate read in place from the in_proj output)
  rms_norm_bwd        - its backward (dx, the gate's gradient; dw in a fixed
                        order)
  adamw_update        - one AdamW step of one leaf in place, the clip scale
                        read on the card; the port's own (XLA fuses the
                        update in JAX)

Under autograd on a CUDA tensor, ``flash_attention``, ``ssd_scan``,
``moe_router``, ``causal_conv`` and ``rms_norm`` run their forward and
backward kernels through a ``torch.autograd.Function``.  ``decode_attention`` (serving) has no
backward: on a CUDA tensor that needs a gradient it raises
(``_grad.refuse_grad``).
"""
from typing import Dict

from .adamw_update import adamw_update
from .causal_conv import causal_conv, causal_conv_bwd
from .decode_attention import decode_attention
from .flash_attention import flash_attention, flash_attention_bwd
from .fused_augment import fused_augment
from .moe_router import moe_router, moe_router_bwd
from .rms_norm import rms_norm, rms_norm_bwd
from .ssd_scan import ssd_scan, ssd_scan_bwd

KERNELS = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
           "decode_attention": decode_attention, "ssd_scan": ssd_scan,
           "ssd_scan_bwd": ssd_scan_bwd, "moe_router": moe_router,
           "moe_router_bwd": moe_router_bwd, "fused_augment": fused_augment,
           "causal_conv": causal_conv, "causal_conv_bwd": causal_conv_bwd,
           "rms_norm": rms_norm, "rms_norm_bwd": rms_norm_bwd, "adamw_update": adamw_update}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


reset_launch_counts()
