"""The distributed layer (counterpart of ``repro/distributed/``).

No eager submodule imports: ``sharding`` imports the model structures
while the models import ``logical`` (``ffn.moe_block`` reads its mesh)
and ``sharding`` (``gather_layer``); importing each module explicitly
avoids the cycle, and ``sharding`` and ``models.transformer`` import
each other as modules, reading each other's names only when called.
"""
