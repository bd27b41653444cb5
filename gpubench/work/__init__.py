"""Operation and byte counts, one module per model family, named by each
configuration file's "work" key."""
