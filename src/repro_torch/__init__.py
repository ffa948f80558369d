"""PyTorch/CUDA port of the batch simulation backend (``repro``'s JAX
package stays beside it as the reference).

The port mirrors ``repro``'s module names so each counterpart is easy to
find.  It imports ``torch`` and never ``jax`` or anything of ``repro``:
the few framework-neutral pieces it needs (cost constants, quorum sizes,
the Pig group partition, the LAN topology) are copied into ``core/``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` explicitly (see ``device.resolve_device``).
"""
