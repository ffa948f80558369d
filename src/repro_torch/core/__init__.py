"""Core of the port: the batch backend's group kernel and the copied
framework-neutral pieces it lowers deployments from."""
