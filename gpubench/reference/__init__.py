"""Plain references, one module per model family, named by each
configuration file's "reference" key; each model runs in the dtype its
configuration states. They import nothing of the system under test."""
