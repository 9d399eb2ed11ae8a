"""Model configurations: the port's own copy of the JAX package's
``repro.configs`` (one frozen dataclass per architecture, the shape cells,
``reduced``). Equal to the original, held against it by the tests."""
