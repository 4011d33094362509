"""Sharding rules over a torch ``DeviceMesh`` (twin of ``repro.distributed``)."""
