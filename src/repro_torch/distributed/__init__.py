"""Distributed training pieces of the port that need no mesh: gradient
compression (``compression``) and fault tolerance (``ft``).  The mesh
and sharding modules are ROADMAP item A7."""
