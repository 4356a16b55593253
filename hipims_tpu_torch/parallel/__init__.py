"""Multi-device and multi-process runs: a 2-D mesh of blocks
(``mesh.py``) stepped in halo-deep windows (``halo_deep.py``).

Replaces the reference's multi-domain decomposition and its halo links
(src/Domain/Links/CDomainLink.cpp, src/MPI/CMPIManager.cpp), as the JAX
package's ``parallel/`` does with a sharded ``jax.sharding.Mesh``.  Here
the blocks are halo-extended tensors on one or more torch devices, held
by one process or dealt out to the ranks of a torch.distributed process
group (``distributed.py``); their halo strips move by slice copies within
a process and by sends between processes, and their CFL maxima meet in a
``torch.maximum`` chain, across processes over the ranks' all-gathered
values.
"""

from .mesh import Mesh, make_mesh  # noqa: F401
