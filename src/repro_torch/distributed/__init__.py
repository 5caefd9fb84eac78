"""The distributed layer (counterpart of ``repro/distributed/``).

No eager submodule imports: ``sharding`` imports the model structures
while the models import ``logical`` (``ffn.moe_block`` reads its mesh);
importing each module explicitly avoids the cycle.
"""
