"""The port's launch: device meshes (``mesh``), collectives on a mesh's
axes and the ``shard_map`` counterpart (``collectives``), the sharding
rules and ``MeshPar`` (``sharding``), abstract placed inputs (``specs``),
the dry-run (``dryrun``) and the training script (``train``).  Importing
any of them starts no process group."""
