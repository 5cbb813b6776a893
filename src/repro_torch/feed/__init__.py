"""repro_torch.feed - the accelerator-feed subsystem of the port (twin of the
JAX package's ``repro.feed``).

Bridges the data service (numpy batches from a session of a distributed
dataset) to tensors on the card: per-host consumer registration, a
background fetch+transfer thread with a double-buffered device queue
(pinned staging, a side CUDA stream, one event per batch), and feed-side
stall metrics that double as the autoscaler's client-latency signal.

  * ``feeder``  - ``DeviceFeeder``, the user-facing pipeline stage.
  * ``metrics`` - ``FeedMetrics`` and the rolling ``StallWindow`` reporter.
  * ``sharded`` - host→device placement (``put_batch``, ``PinnedRing``), the
                  host layout from ``torch.distributed``, and the batch
                  shardings over a mesh with each rank's shard.
"""
from .feeder import DeviceFeeder
from .metrics import FeedMetrics, StallWindow
from .sharded import PinnedRing, host_layout, put_batch

__all__ = [
    "DeviceFeeder",
    "FeedMetrics",
    "PinnedRing",
    "StallWindow",
    "host_layout",
    "put_batch",
]
