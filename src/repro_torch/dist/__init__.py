"""repro_torch.dist - the model-sharding layer of the port (twin of the JAX
package's ``repro.dist``).

  * ``context``        - ``ShardingPlan`` (logical axis assignment), the
                         active plan (``use_plan``), the ``shard_activations``
                         hook the model layers call, the per-dim spec ``P``,
                         ``NamedSharding`` and ``AbstractMesh`` (axis names and
                         sizes, no devices).
  * ``sharding_rules`` - parameter / optimizer-state / batch / KV-cache specs
                         (Megatron-style tensor parallel + FSDP over the data
                         axis).
  * ``placement``      - a ``NamedSharding`` as DTensor placements, and
                         tensors placed by it on a ``DeviceMesh``.
  * ``compression``    - int8 gradient wire compression and a compressed sum
                         over a mesh dim.
"""
from .context import AbstractMesh, NamedSharding, P, ShardingPlan, shard_activations, use_plan

__all__ = ["AbstractMesh", "NamedSharding", "P", "ShardingPlan", "shard_activations", "use_plan"]
