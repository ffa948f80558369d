"""PyTorch/CUDA port of ``repro`` (whose JAX package stays beside it as
the reference): the discrete-event engines (Paxos, PigPaxos and EPaxos
nodes on a virtual-time scheduler, fault plans, the linearizability
audit: plain Python and numpy on the host), the batch simulation
backend, the model zoo's serving and training paths, and the Pig
collective schedules on ``torch.distributed``.

The port mirrors ``repro``'s module names so each counterpart is easy to
find.  It imports ``torch`` and never ``jax`` or anything of ``repro``:
the framework-neutral pieces it needs (the discrete-event engines, cost
constants, quorum sizes, the Pig group partition, the topology, the
workload shape, the fault plans, the model configs) are copied into
``core/``, ``faults/``, ``models/config.py`` and ``configs/``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` explicitly (see ``device.resolve_device``).
"""
