"""The engine replica set: E engine processes behind one shared-memory ring.

The port's copy of the JAX package's ``replicaset/``. The router half
lives here (``ReplicaRouter``, consulted by every front end at submit);
the transport half is the per-replica queues, doorbells and stats rows of
``serve/ipc.py``; the process half is the supervisor forking E engine
children in ``serve/frontend.py``. The JAX package's in-process
simulation harness (``replicaset/sim.py``, its bench's scaling stage) is
not ported: it belongs with the JAX ``bench``, to the port's benchmark,
which is not written yet (ROADMAP A).

Torch-free: front ends import the router; nothing here touches a device.
"""

from mlops_tpu_torch.replicaset.router import ReplicaRouter

__all__ = ["ReplicaRouter"]
