"""Multi-device decode: a device mesh (``mesh``), a batch decoder that
shards each call over the mesh's rows (``sharding.MeshDecoder``) and the
multi-process helpers (``multihost``). Counterpart of the JAX package's
``rocjpeg_tpu/dist``. Importing it starts no process group."""
