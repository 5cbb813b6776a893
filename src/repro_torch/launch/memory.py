"""The dry run's memory analysis: the live set of one step, counted on the
``meta`` device (twin of the JAX package's ``compiled.memory_analysis()``).

``MemoryTracker`` is a ``TorchDispatchMode``.  For each op that is not a view
it adds the ``nbytes`` of every output storage that is new, once per
storage, and a ``weakref`` finalizer on the storage takes them off when the
storage dies.  Storages are keyed by the storage, not by ``data_ptr``: every
``meta`` pointer is 0, and a view shares its base's storage.  An output that
shares an input's storage (an in-place op, ``out=``, an alias) or one that
is already counted adds nothing, so AdamW's in-place updates, the cache
writes and the gradient views the train step presets allocate nothing.  The
peak of the live set is ``temp_bytes``: what the step allocates above the
arguments that exist before it runs (they are not counted).

Why it is the card's number.  The ``meta`` run and the card's run execute
the same Python, so they drop the same references at the same points: a
finalizer fires where the caching allocator frees the block.  Autograd's
reference cycles are the same objects on both devices, and the tracker
does not collect them.  Two kinds of allocation are not an op's output:

* a kernel's scratch.  A CUDA launch function allocates buffers around its
  kernels (``<kernel>/kernel.py``'s ``*_scratch``) that the kernel's
  shape-only op does not: a ``TorchDispatchMode`` does not see the
  ``torch.empty`` calls inside a fake implementation.  The tracker charges
  what each op declares beside its fake (``kernels._shape.<op>_scratch``,
  which calls the launch function's own ``*_scratch``): a transient peak on top
  of the op's outputs, freed when the op returns.  Decode's split workspace
  is persistent (``kernels._shape.decode_workspace``: one a device and
  stream, grown to the largest call's need and never freed): it is charged
  when a call grows it and stays live.  ``fused_augment`` and the forwards
  of the causal conv and the RMSNorm have none, and their entries say so.
  A ``repro_torch`` op with no entry raises rather than count as zero;
* the temporaries PyTorch's own CUDA kernels allocate inside one op, below
  the dispatcher (``HIDDEN_TEMPORARIES``: ``logsumexp``'s shifted copy of its
  input), charged the same way.

What the card holds that the step does not allocate - the cuBLAS workspace
and the decode workspace made before the step, the feeder's prefetched
batches - is not the step's and is not counted; the card's caching
allocator rounds each block up to 512 bytes, the tracker counts the bytes.

On a mesh the tracker is fed by ``dryrun.LocalCounter`` (``record``): it
counts what that counter counts, the local ops on this rank's shards and
the outputs of the collectives, and not DTensor's shape propagation on fake
tensors.

On a CUDA device ``MemoryTracker("cuda", audit=True)`` also reads the
caching allocator around every op and keeps each op whose rise differs from
what the tracker charged it (``misses``): how the card's check finds a
temporary the table lacks.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..kernels import _shape
from ..kernels._scratch import Scratch
from ..kernels._scratch import nbytes as scratch_nbytes

H100_SMS = 132  # SMs of an H100 SXM: the decode split plan on meta
BLOCK_ROUND = 512  # the CUDA caching allocator's rounding of a block


def _logsumexp(self, dim, keepdim=False) -> Scratch:
    # ReduceOps.cpp logsumexp_out_impl: maxes = amax(self, dim, keepdim=True),
    # then sum((self - maxes).exp_()): the shifted copy is as large as self
    dims = [d % self.dim() for d in (dim if isinstance(dim, (list, tuple)) else [dim])]
    kept = tuple(1 if i in dims else n for i, n in enumerate(self.shape))
    return {"maxes": (kept, self.dtype), "shifted": (tuple(self.shape), self.dtype)}


# temporaries a CUDA kernel of PyTorch allocates inside one op, by the op's
# overload packet name
HIDDEN_TEMPORARIES: Dict[str, Callable[..., Scratch]] = {
    "logsumexp": _logsumexp,
}


class MemoryTracker(TorchDispatchMode):
    """The live set of the storages a step creates on ``device_type``:
    ``live`` now, ``peak`` (``temp_bytes``), with each kernel op's scratch
    and each hidden temporary charged as a transient peak on top of its
    outputs.  ``sms``: the SMs of the card whose decode plan a ``meta`` run
    follows (the step starts with no decode workspace, as a process does)."""

    def __init__(self, device_type: str = "meta", *, sms: int = H100_SMS,
                 audit: bool = False):
        super().__init__()
        self.device_type = device_type
        self.sms = sms
        self.round_to = BLOCK_ROUND if device_type == "cuda" else 1
        self.live = 0
        self.peak = 0
        self.allocations = 0
        self.scratch_peak = 0  # the largest transient charge of one op
        self.scratch_allocations = 0  # scratch tensors charged
        self.workspace = 0  # bytes of the decode workspace
        self._sizes: Dict[int, int] = {}
        self.audit = audit
        self.misses: List[Dict[str, Any]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor for t in types if issubclass(t, torch.Tensor)):
            raise RuntimeError(f"MemoryTracker: {func} on {[t.__name__ for t in types]}; a "
                               "step on DTensors is tracked through dryrun.LocalCounter")
        if not self.audit:
            out = func(*args, **kwargs)
            self.record(func, args, kwargs, out)
            return out
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = func(*args, **kwargs)
        rise = torch.cuda.max_memory_allocated() - before
        charged = self.record(func, args, kwargs, out)
        if rise != charged:
            self.misses.append({"op": str(func), "rise": rise, "charged": charged,
                                "shapes": [tuple(t.shape) for t in tree_leaves((args, kwargs))
                                           if isinstance(t, torch.Tensor)][:4]})
        return out

    def _round(self, n: int) -> int:
        return -(-n // self.round_to) * self.round_to

    def _storage(self, func, t: torch.Tensor):
        try:
            return t.untyped_storage()
        except Exception as e:  # a wrapper subclass, a sparse or nested tensor
            raise RuntimeError(f"MemoryTracker: an output of {func} has no storage to key "
                               f"({type(t).__name__}: {e})") from e

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def record(self, func, args, kwargs, out) -> int:
        """Counts ``out``'s new storages of the op ``func(*args, **kwargs)``
        and its scratch; returns the bytes charged to the op's peak (new
        outputs, plus the scratch on top)."""
        start = self.live
        if not func.is_view:
            inputs: Optional[set] = None
            for t in tree_leaves(out):
                if not isinstance(t, torch.Tensor) or t.device.type != self.device_type:
                    continue
                st = self._storage(func, t)
                key = st._cdata
                if key in self._sizes:
                    continue
                if inputs is None:
                    inputs = {self._storage(func, a)._cdata for a in tree_leaves((args, kwargs))
                              if isinstance(a, torch.Tensor) and a.device.type == self.device_type}
                if key in inputs:
                    continue
                n = self._round(st.nbytes())
                self._sizes[key] = n
                self.live += n
                self.allocations += 1
                weakref.finalize(st, self._free, key)
        transient = self._scratch(func, args, kwargs)
        self.scratch_peak = max(self.scratch_peak, transient)
        self.peak = max(self.peak, self.live + transient)
        return self.live - start + transient

    def _scratch(self, func, args, kwargs) -> int:
        """Bytes an op holds above its outputs while it runs; grows the
        persistent decode workspace (whose growth then stays live)."""
        name = func.overloadpacket.__name__
        if func.namespace == "repro_torch":
            if name == "decode_attention":
                (shape, _), = _shape.decode_workspace(*args, **kwargs, sms=self.sms).values()
                need = self._round(shape[0] * 4)
                if need <= self.workspace:
                    return 0
                # the new buffer is made before the old one is freed
                grown, self.workspace = need - self.workspace, need
                self.scratch_allocations += 1
                self.live += grown
                return need - grown
            scratch = getattr(_shape, f"{name}_scratch", None)
            if scratch is None:
                raise RuntimeError(f"MemoryTracker: the kernel op {func} has no scratch "
                                   f"function, kernels._shape.{name}_scratch")
            spec = scratch(*args, **kwargs)
        elif name in HIDDEN_TEMPORARIES:
            spec = HIDDEN_TEMPORARIES[name](*args, **kwargs)
        else:
            return 0
        self.scratch_allocations += len(spec)
        return sum(self._round(n) for n in scratch_nbytes(spec).values())

    def report(self) -> Dict[str, int]:
        """{"temp_bytes": the peak, "live_end_bytes": live now,
        "allocations", "scratch_peak_bytes", "decode_workspace_bytes"}."""
        return {"temp_bytes": self.peak, "live_end_bytes": self.live,
                "allocations": self.allocations, "scratch_peak_bytes": self.scratch_peak,
                "decode_workspace_bytes": self.workspace}

