"""Scenario layer of the port: the batch-path subset of ``repro``'s
declarative scenarios, registry, catalog and runner, writing the same
``repro-experiments/v1`` artifacts."""
