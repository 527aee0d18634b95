"""The distribution layer: the port of ``repro.distributed`` (``context``,
``layouts``, ``compression``, ``pipeline``) on ``torch.distributed``, plus
``collectives``, the mesh-axis collectives the reference gets from
``shard_map``.  The reference's ``compat`` (a shim against JAX version
drift) has no twin."""
