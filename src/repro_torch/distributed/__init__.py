"""The port's distributed layer: sharding rules and specs (``sharding``),
the sequence-sharded decode collectives (``collectives``) and the
activation-sharding hooks (``actsharding``)."""
