"""The benchmark's own machinery: discovery by name, weights, traffic,
the call recorder, window arithmetic, FLOP and byte counts, the
profiler's reading, and the check that decides ``correct``."""
