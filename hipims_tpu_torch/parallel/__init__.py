"""Multi-device runs inside one process: a 2-D mesh of blocks
(``mesh.py``) stepped in halo-deep windows (``halo_deep.py``).

Replaces the reference's multi-domain decomposition and its halo links
(src/Domain/Links/CDomainLink.cpp, src/MPI/CMPIManager.cpp), as the JAX
package's ``parallel/`` does with a sharded ``jax.sharding.Mesh``.  Here
the blocks are halo-extended tensors held by one process, on one or more
torch devices; their halo strips move by slice copies and their CFL maxima
meet in one ``torch.maximum`` chain.
"""

from .mesh import Mesh, make_mesh  # noqa: F401
