"""The harness's own pieces: spec discovery, the window's statistics, the
traced run's reduction, seeded weights, and the frozen copies of the port's
card query, kernel-name table and work counts."""
